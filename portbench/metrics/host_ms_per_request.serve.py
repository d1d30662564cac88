"""Host milliseconds a request spends in ``forward_random`` before its final
``torch.cuda.synchronize``: the enqueue the host does for one request, over
all requests of the traced window (the benchmark's host clock)."""


def read(s):
    v = s.extra.get("host_s_to_sync") or []
    return 1e3 * sum(v) / len(v) if v else None
