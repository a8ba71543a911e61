"""upload_share.train: the training loop's host time uploading batches
(contiguous copy, pinning, the copy's enqueue: the program's train.upload
spans) over the traced window, in %."""

from portbench.harness import recorder


def read(out, ctx):
    return recorder.span_share(out, "train.upload")
