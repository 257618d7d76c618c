"""Input bytes over container bytes of the entries the window encoded,
each counted once: every pass makes the same containers, so the ratio
does not depend on how many passes the window held."""


def read(run):
    size = {}
    for r in run.records:
        if r.ok and r.item not in size:
            size[r.item] = r.size
    if not size:
        return None
    return sum(len(run.items[i].data) for i in size) / sum(size.values())
