"""Milliseconds of a main training step: per main step, from the start of
the first device operation it enqueued to the end of its last, over all
main steps of the traced window."""


def read(s):
    v = [x["device_s"] for x in s.spans.get("main_step", []) if x["device_s"]]
    return 1e3 * sum(v) / len(v) if v else None
