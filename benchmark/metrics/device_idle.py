"""1 - (union of the device operations' intervals) / (the stretch's
length), in %: the share of the stretch in which the card ran nothing."""


def read(stretch, params, cell):
    length = stretch.end - stretch.start
    if not stretch.ops or length <= 0:
        return None
    return 100.0 * (1.0 - stretch.busy_ns() / length)
