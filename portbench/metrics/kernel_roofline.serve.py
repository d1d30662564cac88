"""The hand-written kernels' share of their roofline: the sum over every
call of every kernel in ``kernels/`` of its least time (``work.py``: the
slower of its operations over the peaks and its bytes over 3.35 TB/s)
over the sum of the device time those calls enqueued."""


def read(s):
    ks = [k for k in s.kernels.values() if k["calls"] and k["device_s"] > 0]
    if not ks:
        return None
    return 100.0 * sum(k["least_s"] for k in ks) / sum(k["device_s"] for k in ks)
