"""One schedule cycle's share of the H100's peak: the operations of its
content steps and its main step (the plain reference's forwards and
backwards, counted on the meta device at the cell's shapes) over the bf16
peak, divided by the time a cycle took in the traced window."""
from portbench.work import PEAKS


def read(s):
    ops, cycles = s.extra.get("ops_per_cycle"), s.extra.get("cycles")
    if not ops or not cycles or s.window_s <= 0:
        return None
    return 100.0 * sum(n / PEAKS[p] for p, n in ops.items()) / (s.window_s / cycles)
