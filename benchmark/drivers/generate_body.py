"""Entry of the body path: per request `ops.audio.get_mfcc(wav_path, sr=22000,
fps=30, device)` then `Pipeline.generate_body(mfcc, speaker, num_samples,
seed, noise)` -> conv poses (num_samples, 4 (T // 4), channels); the path
that serves the 6-D model, whose poses `generate` does not assemble.

Spans of the traced run: `ops.audio.get_mfcc` (mfcc), `Pipeline.generate_body`
(body_stage) and inside it `models.body.sample_tokens_fused` (ar_decode)."""
from benchmark import gen


class Entry:
    @staticmethod
    def call(st, path, speaker, samples, seed, noise):
        import talkshow_torch.ops.audio as audio_ops
        feat = audio_ops.get_mfcc(path, sr=22000, fps=30, device=st.pipe.device)
        return st.pipe.generate_body(feat.cpu().numpy(), speaker, num_samples=samples,
                                     seed=seed, noise=noise)

    @staticmethod
    def wrap(spans, st):
        import talkshow_torch.models.body as body
        import talkshow_torch.ops.audio as audio_ops
        spans.wrap(audio_ops, "get_mfcc", "mfcc")
        spans.wrap(st.pipe, "generate_body", "body_stage")
        spans.wrap(body, "sample_tokens_fused", "ar_decode", note=gen.decode_note)


def setup(run):
    return gen.setup(run, Entry)


window = gen.window
release = gen.release


def check(run, st):
    return gen.check(run, st, with_face=False)
