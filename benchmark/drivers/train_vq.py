"""Entry `train.steps.make_body_vq_step(rep6d=...)`: stage 1, the body and
hand VQ-VAEs, one step a pool batch of synthetic pose windows ((B, T, 330)
6-D poses, or 165 axis-angle channels), float32 with TF32 off."""
from __future__ import annotations

import torch

from benchmark import training
from benchmark import weights as bench_weights
from benchmark.reference import train as ref_train


def setup(run):
    from talkshow_torch.models.vqvae import VQVAE
    from talkshow_torch.ops.vq import VQState
    from talkshow_torch.train.optim import SkipNonfiniteAdam
    from talkshow_torch.train.steps import BodyVQState, make_body_vq_step

    wl, cfg, dev = run.workload, run.cfg, run.device
    vq = cfg["vq"]
    rep6d = wl["rep6d"]
    st = training.State()
    w = bench_weights.draw(cfg, run.seed, dev)
    st.w = {k: w[k] for k in ("vq_body", "vq_hand", "codebook_body", "codebook_hand")}
    del w
    B, T, n = wl["batch"], wl["window"], wl["pool_batches"]
    g = training.draw_gen(run, 6)
    st.pool = training.smooth((n, B, T, 330 if rep6d else 165), g, dev)
    st.pool_size, st.frames = n, B * T
    with torch.device("meta"):
        models = {p: VQVAE(vq[f"{p}_channels"], vq["embedding_dim"], vq["num_hiddens"],
                           vq["num_residual_layers"]) for p in ("body", "hand")}
    for p, m in models.items():
        m.to_empty(device=dev).load_state_dict(st.w[f"vq_{p}"])
    K = vq["code_num"]
    states = {p: VQState(st.w[f"codebook_{p}"].clone(), torch.zeros_like(st.w[f"codebook_{p}"]),
                         torch.zeros(K, device=dev), torch.zeros((), dtype=torch.int32,
                                                                 device=dev))
              for p in models}
    _, step = make_body_vq_step(models["body"], models["hand"], learning_rate=1e-4,
                                code_num=K, rep6d=rep6d)
    opt = SkipNonfiniteAdam([p for m in models.values() for p in m.parameters()], 1e-4)
    state = BodyVQState(models, states, opt)

    def one(i):
        _, metrics = step(state, {"poses": st.pool[i]})
        return lambda: sum(float(v) for k, v in metrics.items() if k != "nonfinite_skips")

    st.step = one
    st.optimizer = opt.adam
    st.named = lambda: [(f"{p}.{n}", q) for p, m in models.items()
                        for n, q in m.named_parameters()]
    st.theta0 = {f"{p}.{n}": t for p in models for n, t in st.w[f"vq_{p}"].items()}
    st.books = lambda: {f"codebook.{p}": (state.vq[p].embeddings, st.w[f"codebook_{p}"])
                        for p in models}
    st.ref_batch = lambda i: {"poses": st.pool[i]}

    def release():
        state.models.clear()
        state.vq.clear()
        state.optimizer = None

    st.release = release
    training.first_steps(run, st)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return st


window = training.window
release = training.release


def check(run, st):
    out = training.check(run, st, lambda: ref_train.VQStep(run.cfg, st.w, run.device,
                                                            run.workload["rep6d"]))
    if run.hooks.get("diagnose"):
        run.extra["code_flips"] = code_flips(run, st)
    return out


@torch.no_grad()
def code_flips(run, st) -> dict:
    """For the look behind a high reading: on step 1's batch, the rows whose
    nearest code the program's search (K4 on the card) and the reference's
    argmin pick differently from the same encoder outputs, per part."""
    from talkshow_torch.ops.vq import nearest_code
    ref = ref_train.VQStep(run.cfg, st.w, run.device, run.workload["rep6d"])
    conv = ref_train.conv_channels(st.pool[0], run.workload["rep6d"])
    out = {}
    for name, x in (("body", conv[..., :ref.split]), ("hand", conv[..., ref.split:])):
        z = ref.models[name].encoder(x)
        flat = z.reshape(-1, z.shape[-1])
        book = ref.books[name].e
        a, b = ref_train.nearest(flat, book), nearest_code(flat, book)
        d = ((flat[:, None, :] - book[None]) ** 2).sum(-1)
        flips = (a != b).nonzero()[:, 0]
        out[name] = {"rows": int(flat.shape[0]), "flips": int(flips.numel()),
                     "dist_gap": [float(d[r, b[r]] - d[r, a[r]]) for r in flips[:5]]}
    return out


