"""Share of the training steps replayed from a captured CUDA graph, %: the
program's `train_graph_replay` counter charged to its `train_step` roots
over their count.  None where no root replayed: an untraced run, or a
program that captures no step."""
from benchmark import program_trace


def read(run):
    return program_trace._per_root("train_step", lambda s, r: 100.0 * s["roots"]["train_step"]
                                   .get("counts", {}).get("train_graph_replay", 0)) or None
