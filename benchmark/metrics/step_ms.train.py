"""Milliseconds of the supervised step: the host clock around each call
of the train step that ``train_one_epoch`` makes in the window, until the
device has finished it (the loop reads the loss back right after), mean
over the steps completed in the window."""


def read(run):
    s = run.layer.get("step_s")
    return 1e3 * sum(s) / len(s) if s else None
