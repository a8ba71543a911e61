"""Checkpoint identity for the artifacts derived from a checkpoint.

Counterpart of vqwild_tpu/models/quant.py. Only ``checkpoint_fingerprint``
is ported so far: the command line keys its feature caches by it. The int8
post-training quantization and its calibration files are not ported yet.
"""

from __future__ import annotations

import hashlib
import os


def checkpoint_fingerprint(test_load: str) -> str:
    """10-hex identity of a checkpoint's weights: path + per-file
    mtime/size, the JAX package's value for the same file or directory.
    Derived artifacts living beside/inside the checkpoint (int8_calib*.json)
    are excluded so writing them does not change the fingerprint of the
    weights they were derived from."""
    p = os.path.abspath(test_load)
    h = hashlib.sha256(p.encode())
    try:
        if os.path.isdir(p):
            for root, _, files in sorted(os.walk(p)):
                for fn in sorted(files):
                    # substring, not prefix: a file checkpoint inside this
                    # directory gets sibling <file>.int8_calib-<fp>.json
                    # artifacts, which must not churn the dir fingerprint
                    if "int8_calib" in fn:
                        continue
                    st = os.stat(os.path.join(root, fn))
                    h.update(f"{fn}:{st.st_mtime_ns}:{st.st_size}".encode())
        else:
            st = os.stat(p)
            h.update(f"{st.st_mtime_ns}:{st.st_size}".encode())
    except OSError:
        pass
    return h.hexdigest()[:10]
