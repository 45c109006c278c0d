"""Evaluation of the port (talkshow_tpu/eval): the metrics, FGD over the
body AE, the metric runners of the reference's test scripts and the legacy
2-D keypoint suite."""
