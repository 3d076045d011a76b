"""Host milliseconds of one ``regridder.regrid_granule`` call, from the
benchmark's own span around each call in the traced window (closed by a
device synchronise), averaged over every granule the window regridded."""


def read(ctx):
    spans = [e - s for m in ctx.months for s, e in m["regrid_spans"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
