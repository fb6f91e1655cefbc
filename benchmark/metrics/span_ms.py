"""Host ms per span named ``span`` in the stretch: the spans' summed length
over their count."""


def read(stretch, params, cell):
    spans = [hi - lo for name, lo, hi in stretch.spans if name == params["span"]]
    return sum(spans) / len(spans) / 1e6 if spans else None
