"""Share of the traced window in which no operation ran on the device: one
less the union of the kernels', memcpys' and memsets' intervals over the
window's length."""


def read(s):
    if s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
