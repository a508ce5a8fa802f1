#!/usr/bin/env python3
"""Serving A/B of two checkouts of the PyTorch port on one card.

    python3 tools/webhook_ab.py PARENT_DIR CHANGE_DIR

Starts each checkout's webhook CLI (``python3 -m
cedar_tpu_torch.cli.webhook``, default flags but the decision cache off,
the card) in the order
parent, change, change, parent, over one directory store holding
synth_corpus(10000, seed=0) and chip_smoke.py's two gated policies, and
drives each server as chip_smoke.py phase 8 does: phase 8's first 300
gated SARs one at a time on one connection, then 4096 gated and 4096
plain SARs from 64 clients. Prints the card line, then one JSON line per
server: its ready time (the first start of each checkout includes its
kernel and encoder builds), c=1 p50 / p99, and requests/s and p99 of
each c=64 window. Comparing the two only inside one run, in turns, is
the point: hosts differ between runs. Needs chip_smoke.py beside this
directory's parent (the repository root) and a CUDA card.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cedar_tpu_torch.corpus.synth import synth_corpus, synth_source  # noqa: E402


def cache_off_flags(tree: str) -> list:
    """``--decision-cache-size 0`` when the checkout's CLI has a decision
    cache: the A/B measures the device path, which cached answers skip
    (a checkout from before the cache rejects the flag)."""
    with open(os.path.join(tree, "cedar_tpu_torch", "cli", "webhook.py")) as f:
        return ["--decision-cache-size", "0"] if "--decision-cache-size" in f.read() else []


def serve(tree: str, cfg: str, log_path: str):
    """(process, port, seconds to ready) of one checkout's CLI."""
    port, mport = cs.free_port(), cs.free_port()
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cedar_tpu_torch.cli.webhook", "--config", cfg, "--insecure",
             "--secure-port", str(port), "--metrics-port", str(mport), *cache_off_flags(tree)],
            cwd=tree, stdout=log, stderr=subprocess.STDOUT)
    while True:
        try:
            if cs.http_get(mport, "/readyz")[0] == 200:
                return proc, port, time.monotonic() - t0
        except OSError:
            pass
        if proc.poll() is not None:
            with open(log_path) as f:
                sys.exit(f"{tree}: the webhook exited before it was ready:\n{f.read()[-3000:]}")
        time.sleep(0.2)


def main() -> None:
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    parent, change = (os.path.abspath(p) for p in sys.argv[1:])
    corpus = synth_corpus(10000, seed=0)
    gated = cs.gated_bodies(corpus, 4096, seed=6)
    plain = corpus.sar_bodies(4096, seed=2)
    with tempfile.TemporaryDirectory(prefix="webhook-ab-") as tmp:
        pol = os.path.join(tmp, "policies")
        os.mkdir(pol)
        with open(os.path.join(pol, "synth.cedar"), "w") as f:
            f.write(synth_source(10000, seed=0))
        with open(os.path.join(pol, "gated.cedar"), "w") as f:
            f.write(cs.FALLBACK_POLICY + cs.NATIVE_OPAQUE_POLICY)
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"spec": {"stores": [{"type": "directory",
                                            "directoryStore": {"path": pol}}]}}, f)
        print(cs.card_line(), flush=True)
        for k, (name, tree) in enumerate((("parent", parent), ("change", change),
                                          ("change", change), ("parent", parent))):
            proc, port, ready = serve(tree, cfg, os.path.join(tmp, f"{k}.log"))
            try:
                client = cs.Client(port)
                lat = [client.post(b)[1] for b in gated[:300]]
                client.close()
                out = {"tree": name, "ready_s": round(ready, 1),
                       "c1_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
                       "c1_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3)}
                for label, bodies in (("c64", gated), ("c64_nogated", plain)):
                    wall, lat64, _got, errors = cs.drive(port, bodies, 64)
                    out[f"{label}_rps"] = round(len(bodies) / wall, 1)
                    out[f"{label}_p99_ms"] = round(float(np.percentile(lat64, 99)) * 1e3, 3)
                    out[f"{label}_errors"] = len(errors)
            finally:
                proc.terminate()
                proc.wait(timeout=60)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
