"""Device ms per span named ``span``: the summed time of the device
operations launched from inside those spans, over the spans' count."""


def read(stretch, params, cell):
    spans = [s for s in stretch.spans if s[0] == params["span"]]
    ops = stretch.ops_in(params["span"])
    if not spans or not ops:
        return None
    return sum(hi - lo for _, lo, hi, _ in ops) / len(spans) / 1e6
