"""Milliseconds of a scene's backbone: CUDA events around each call of
``InteractiveEngine.run_backbone`` in the traced window, mean over the
scenes."""


def read(run):
    ms = run.layer.get("backbone_ms")
    return sum(ms) / len(ms) if ms else None
