"""The open-loop load generator, a process of its own so that its clock
does not share the server's interpreter lock.

    python portbench/harness/loadgen.py '<json spec>'

It builds the request bodies from the seed, prints ``{"ready": true}``,
reads one line ``{"port": P}`` from standard input and warms the server
with ``warm_s`` seconds of the same traffic (another schedule from the
seed; its replies are dropped), prints ``{"warmed": true}``, and on the
line ``{"go": true}`` sends the timed schedule (the same arrivals for every
seed; the seed picks what each request carries): request i at its due time
whatever the earlier ones are doing (one thread each), timed from its due
time to the last byte of its reply. After the last due time it waits up to
``grace_s`` for the replies still out, then prints one JSON line: status,
latency and lateness of every request, the pool entry each sent and the
reply bodies. NumPy and the standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench.harness import traffic  # noqa: E402


def bodies(spec: dict):
    """(path, [body bytes] of the pool, content type)."""
    if spec["endpoint"] == "clip":
        pool = [traffic.npz_body(*traffic.smooth_clip(spec["seed"], i, spec["frames"],
                                                      spec["crop"]))
                for i in range(spec["pool"])]
        return f"/query/clip?k={spec['k']}", pool, "application/octet-stream"
    qs = traffic.moment_queries(spec["seed"], spec["pool"], spec["feat_dim"])
    pool = [json.dumps({"feature": q.tolist(), "k": spec["k"], "nms": spec["nms"]}).encode()
            for q in qs]
    return "/query/moments", pool, "application/json"


def send_all(url, ctype, pool, due, pick, timeout_s, grace_s):
    """Open loop: request i at its due time, in a thread of its own."""
    n = len(due)
    status, latency, late, replies = [0] * n, [None] * n, [0.0] * n, [None] * n
    left = threading.Semaphore(0)

    def send(i: int, due_t: float) -> None:
        late[i] = time.perf_counter() - due_t
        try:
            req = urllib.request.Request(url, data=pool[pick[i]],
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                raw = r.read()
                status[i] = r.status
            latency[i] = time.perf_counter() - due_t
            replies[i] = raw.decode()
        except urllib.error.HTTPError as e:
            status[i] = e.code
        except OSError:
            status[i] = -1
        finally:
            left.release()

    t0 = time.perf_counter()
    for i, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        threading.Thread(target=send, args=(i, t0 + d), daemon=True).start()
    deadline = time.perf_counter() + grace_s
    done = 0
    while done < n and left.acquire(timeout=max(0.0, deadline - time.perf_counter())):
        done += 1
    # a request still out after the grace is a failure (-2)
    return {"n": n, "pick": pick.tolist(), "due": due.tolist(),
            "status": [s if latency[i] is not None or s else -2 for i, s in enumerate(status)],
            "latency": latency, "late": late, "replies": replies,
            "window_s": time.perf_counter() - t0}


def main() -> None:
    spec = json.loads(sys.argv[1])
    path, pool, ctype = bodies(spec)
    # every seed sends the same arrivals; the seed chooses what each carries
    due = traffic.schedule(spec["rate"], spec["seconds"], traffic.DATA_SEED)
    pick = traffic.picks(len(due), len(pool), spec["seed"])
    print(json.dumps({"ready": True}), flush=True)
    go = json.loads(sys.stdin.readline())
    url = f"http://127.0.0.1:{go['port']}{path}"
    if spec.get("warm_s", 0) > 0:
        warm_seed = traffic.sub_seed(spec["seed"], traffic.ROLE_WARM)
        warm = traffic.schedule(spec["rate"], spec["warm_s"], warm_seed)
        send_all(url, ctype, pool, warm, traffic.picks(len(warm), len(pool), warm_seed),
                 spec["timeout_s"], spec["grace_s"])
    print(json.dumps({"warmed": True}), flush=True)
    json.loads(sys.stdin.readline())
    out = send_all(url, ctype, pool, due, pick, spec["timeout_s"], spec["grace_s"])
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    os._exit(0)  # replies still out after the grace are failures; their threads end with us


if __name__ == "__main__":
    main()
