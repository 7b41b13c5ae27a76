"""Device milliseconds a click: the device time of every operation that a
``get_next_click`` call started in the traced window, over those calls."""


def read(run):
    n = run.trace.span_n.get("click", 0)
    if not n:
        return None
    return 1e3 * run.trace.span_device_s.get("click", 0.0) / n
