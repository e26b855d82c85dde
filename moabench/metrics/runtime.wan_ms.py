"""Mean modelled WAN time (``RequestRecord.wan_s``: uplink queue and
transfer before the first enqueue) of the window's finished requests, in
ms. Layer: serving/runtime.py links."""


def read(run):
    w = [r["wan_s"] for r in run.requests
         if r["finished"] and r["wan_s"] is not None]
    return 1e3 * sum(w) / len(w) if w else None
