"""batch_rows.clip: query rows per GalleryIndex.topk call, the service's
micro-batch, mean over the traced window."""


def read(out, ctx):
    rows = out.counters.get("topk_rows")
    return sum(rows) / len(rows) if rows else None
