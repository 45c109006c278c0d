"""Entry `train.steps.make_body_pixel_step`: stage 2, the Gated PixelCNN
prior and the audio encoder on the token grids of the frozen VQ-VAEs,
float32 with TF32 off.  Set-up fills the token cache of the whole pool
through `train.steps.make_token_encoder` (K4 twice a batch), as the
trainer's first epoch leaves it, and every step reads its batch's cached
tokens; the audio dropout's keep masks come with the batches."""
from __future__ import annotations

import torch

from benchmark import training
from benchmark import weights as bench_weights
from benchmark.reference import train as ref_train


def setup(run):
    from talkshow_torch.models.pixelcnn import GatedPixelCNN
    from talkshow_torch.models.vqvae import VQVAE, AudioEncoder
    from talkshow_torch.ops.vq import VQState
    from talkshow_torch.train.optim import SkipNonfiniteAdam
    from talkshow_torch.train.steps import PixelState, make_body_pixel_step, make_token_encoder

    wl, cfg, dev = run.workload, run.cfg, run.device
    vq, pr, ae = cfg["vq"], cfg["prior"], cfg["audio_encoder"]
    st = training.State()
    st.w = bench_weights.draw(cfg, run.seed, dev)
    del st.w["face"]
    B, T, n = wl["batch"], wl["window"], wl["pool_batches"]
    H = T // 4
    g = training.draw_gen(run, 6)
    st.poses = training.smooth((n, B, T, 165), g, dev)
    st.feat = 10.0 * training.smooth((n, B, T, ae["in_dim"]), g, dev, 0.5, 8.0)
    st.speaker = torch.randint(0, pr["n_classes"], (n, B), generator=g, device=dev)
    st.keep = torch.rand((n, B, H), generator=g, device=dev) < 0.9
    st.pool_size, st.frames = n, B * T
    with torch.device("meta"):
        vqs = {p: VQVAE(vq[f"{p}_channels"], vq["embedding_dim"], vq["num_hiddens"],
                        vq["num_residual_layers"]) for p in ("body", "hand")}
        prior = GatedPixelCNN(input_dim=pr["input_dim"], dim=pr["dim"], n_layers=pr["n_layers"],
                              n_classes=pr["n_classes"], audio_channels=ae["num_hiddens"],
                              hidden=pr["hidden"])
        audio = AudioEncoder(ae["in_dim"], num_hiddens=ae["num_hiddens"])
    for p, m in vqs.items():
        m.to_empty(device=dev).load_state_dict(st.w[f"vq_{p}"])
    prior.to_empty(device=dev).load_state_dict(st.w["prior"])
    audio.to_empty(device=dev).load_state_dict(st.w["audio_enc"])
    K = vq["code_num"]
    frozen = {p: VQState(st.w[f"codebook_{p}"].clone(), torch.zeros_like(st.w[f"codebook_{p}"]),
                         torch.zeros(K, device=dev), torch.zeros((), dtype=torch.int32,
                                                                 device=dev))
              for p in vqs}
    _, step = make_body_pixel_step(prior, audio, vqs["body"], vqs["hand"], frozen,
                                   learning_rate=1e-4, max_grad_norm=5.0)
    encode = make_token_encoder(vqs["body"], vqs["hand"], frozen)
    st.tokens = torch.stack([encode(st.poses[i]) for i in range(n)])
    models = {"prior": prior, "audio": audio}
    opt = SkipNonfiniteAdam([p for m in models.values() for p in m.parameters()], 1e-4, 5.0)
    state = PixelState(models, opt)

    def batch(i, tokens):
        return {"aud_feat": st.feat[i], "speaker": st.speaker[i], "tokens": tokens,
                "aud_keep": st.keep[i]}

    def one(i):
        _, metrics = step(state, batch(i, st.tokens[i]))
        return lambda: float(metrics["ce_loss"])

    st.step = one
    st.optimizer = opt.adam
    st.named = lambda: [(f"{p}.{n}", q) for p, m in models.items()
                        for n, q in m.named_parameters()]
    st.theta0 = {**{f"prior.{n}": t for n, t in st.w["prior"].items()},
                 **{f"audio.{n}": t for n, t in st.w["audio_enc"].items()}}
    st.books = dict
    st.ref_batch = lambda i: batch(i, None)

    def token_mismatch(ref):
        return float(torch.stack([(ref.tokens(st.poses[i]) != st.tokens[i]).float().mean()
                                  for i in range(n)]).mean())

    st.token_mismatch = token_mismatch

    def control_mismatch(ctl):
        ref = ref_train.PixelStep(run.cfg, st.w, dev)
        training.tf32(False)
        want = [ref.tokens(st.poses[i]) for i in range(n)]
        training.tf32(True)
        return float(torch.stack([(ctl.tokens(st.poses[i]) != want[i]).float().mean()
                                  for i in range(n)]).mean())

    st.control_mismatch = control_mismatch

    def release():
        models.clear()
        vqs.clear()
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
    ref_tokens = {}

    def make():
        ref = ref_train.PixelStep(run.cfg, st.w, run.device)
        if not ref_tokens:
            ref_tokens.update({i: ref.tokens(st.poses[i]) for i in range(training.FIRST)})
        return ref

    out = training.check(run, st, make, tokens=lambda i: ref_tokens[i])
    if run.hooks.get("diagnose"):      # the look behind a high reading
        run.extra["token_mismatch_first_steps"] = [
            int((ref_tokens[i] != st.tokens[i]).sum()) for i in range(training.FIRST)]
    return out
