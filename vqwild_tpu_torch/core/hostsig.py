"""Host CPU identity fingerprint for compiled host artifacts (a copy of
vqwild_tpu/core/hostsig.py).

The native engine's ``-march=native`` shared object is host-ISA-specific:
reusing it after a host swap can execute instructions the new CPU lacks
(SIGILL). Keying the artifact by a digest of the CPU's model + feature flags
makes a host swap a rebuild instead of a crash.
"""

from __future__ import annotations

import functools
import hashlib
import platform


@functools.lru_cache(maxsize=1)
def host_cpu_signature() -> str:
    """10-hex digest of this host's CPU identity (arch + model + ISA flags)."""
    bits = [platform.machine()]
    seen = set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                # one core's worth is enough; x86 says "model name"/"flags",
                # arm64 says "Features"/"CPU part"
                if key in ("model name", "flags", "Features", "CPU part"):
                    if key in seen:
                        break
                    seen.add(key)
                    bits.append(line.strip())
    except OSError:
        bits.append(platform.processor() or "unknown")
    return hashlib.sha256("\n".join(bits).encode()).hexdigest()[:10]
