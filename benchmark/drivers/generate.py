"""Entry `Pipeline.generate(wav_path, speaker, num_samples, seed, noise)`:
the whole clip, face stage, body stage and assembly, one call a request.

Spans of the traced run: `ops.audio.get_mfcc` (mfcc), `Pipeline.generate_face`
(face_stage), `Pipeline.generate_body` (body_stage), `Pipeline.assemble_full`
(assembly), and inside the body stage `models.body.sample_tokens_fused`
(ar_decode, with the decode's batch and rows noted for its roofline)."""
from benchmark import gen


class Entry:
    @staticmethod
    def call(st, path, speaker, samples, seed, noise):
        return st.pipe.generate(path, speaker, num_samples=samples, seed=seed, noise=noise)

    @staticmethod
    def wrap(spans, st):
        import talkshow_torch.models.body as body
        import talkshow_torch.ops.audio as audio_ops
        spans.wrap(audio_ops, "get_mfcc", "mfcc")
        spans.wrap(st.pipe, "generate_face", "face_stage")
        spans.wrap(st.pipe, "generate_body", "body_stage")
        spans.wrap(st.pipe, "assemble_full", "assembly")
        spans.wrap(body, "sample_tokens_fused", "ar_decode", note=gen.decode_note)


def setup(run):
    return gen.setup(run, Entry)


window = gen.window
release = gen.release


def check(run, st):
    return gen.check(run, st, with_face=True)
