"""Device ms per evaluated image of host-device copies (both directions)
over the traced splits."""


def read(r):
    if r.trace is None or r.kind != "eval_split" or not r.counts["images"]:
        return None
    ns = sum(e - s for s, e, n, k, _, _ in r.trace.in_window()
             if k == "memcpy" and ("HtoD" in n or "DtoH" in n))
    return ns / 1e6 / r.counts["images"]
