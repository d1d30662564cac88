"""The forward's share of the H100's peak: its operations (the plain
reference's convs and linears, counted on the meta device at the cell's
shapes, by the precision the program runs each in) over each precision's
published peak, divided by the mean time a request took in the traced
window."""
from portbench.work import PEAKS


def read(s):
    ops = s.extra.get("ops_per_request")
    req = [r["host_s"] for r in s.spans.get("request", [])]
    if not ops or not req:
        return None
    return 100.0 * sum(n / PEAKS[p] for p, n in ops.items()) / (sum(req) / len(req))
