"""cedar-webhook (port): the SubjectAccessReview webhook on the card.

    python -m cedar_tpu_torch.cli.webhook --config store-config.json --insecure

Wiring of the JAX package's cli/webhook.py for one engine and one entry
point: read the store config, build the tiered stores, compile them into a
TorchPolicyEngine on ``--device`` (CUDA unless ``--device cpu`` is given;
without CUDA the start fails), put the native SAR fast path and its
micro-batcher in front of it, and serve ``POST /v1/authorize`` (TLS with
self-signed certs unless ``--insecure`` or cert files are given) plus the
plain health and metrics server.

``--backend device`` (the default) serves from the engine;
``--backend interpreter`` serves from the Python interpreter only, with no
engine. The policies load once, at start. Flags of the JAX CLI that this
port does not serve (admission, cache, fleet, tenancy, tracing, ...) do
not exist here, so argparse rejects them.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
from typing import List, Optional

from ..server.authorizer import CedarWebhookAuthorizer
from ..server.certs import maybe_self_signed_certs
from ..server.http import DEFAULT_ADDRESS, DEFAULT_PORT, METRICS_PORT, WebhookServer
from ..stores.config import cedar_config_stores, parse_config

log = logging.getLogger(__name__)


def build_server(args) -> WebhookServer:
    """stores -> authorizer -> engine (loaded from the stores) -> fast
    path -> WebhookServer. Raises when the device is unavailable, a store
    type is not ported, or the native encoder or the kernels cannot be
    built."""
    certfile, keyfile = args.tls_cert_file, args.tls_private_key_file
    if args.insecure:
        certfile = keyfile = None
    elif not (certfile and keyfile):
        certfile, keyfile = maybe_self_signed_certs(args.cert_dir)

    config = None
    if args.config:
        with open(args.config) as f:
            config = parse_config(f.read())
    stores = cedar_config_stores(config)

    fastpath = None
    if args.backend == "interpreter":
        if not len(stores.stores):
            log.warning("no policy stores configured; authorizer will no-opinion")
        authorizer = CedarWebhookAuthorizer(stores)
    else:
        from ..engine.evaluator import TorchPolicyEngine

        if not len(stores.stores):
            raise ValueError("--backend device needs at least one policy store (--config)")
        engine = TorchPolicyEngine(device=args.device)
        stats = engine.load([s.policy_set() for s in stores])
        log.info("engine on %s loaded: %s", engine.device, stats)
        authorizer = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
        # nvcc and every first-use cost of the device paths now, not
        # inside the first requests' deadlines; the CPU's plain versions
        # have no per-shape first-use cost, so one bucket does there
        warm = engine.warmup(args.max_batch if engine.device.type == "cuda" else 1)
        if engine.device.type == "cuda":
            from ..ops import cuda_match

            # the launch counts describe served traffic from 0; the
            # warm-up's stay in engine.stats["warmup_launches"]
            cuda_match.reset_launch_counts()
        log.info("engine warmed up: launches %s", warm)
        if not args.no_native:
            from ..engine.fastpath import SARFastPath
            from ..native import set_encode_threads

            if args.native_encode_threads > 0:
                set_encode_threads(args.native_encode_threads)
            fastpath = SARFastPath(engine, authorizer)
            fastpath.prepare()
            log.info("native SAR fast path enabled")

    server = WebhookServer(
        authorizer=authorizer,
        address=args.bind_address,
        port=args.secure_port,
        metrics_port=args.metrics_port,
        certfile=certfile,
        keyfile=keyfile,
        fastpath=fastpath,
        batch_window_s=args.batch_window_us / 1e6,
        max_batch=args.max_batch,
        request_timeout_s=args.request_timeout_ms / 1e3 if args.request_timeout_ms > 0 else None,
        drain_grace_s=args.shutdown_grace_seconds,
        pipeline_depth=args.pipeline_depth,
        encode_workers=args.encode_workers,
    )
    if fastpath is not None:
        from ..native import _default_encode_threads

        server.metrics.set_native_encode_threads(_default_encode_threads())
    return server


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cedar-webhook",
        description="Cedar authorization webhook for Kubernetes (PyTorch/CUDA port)",
    )
    cedar = parser.add_argument_group("cedar")
    cedar.add_argument("--config", default="", help="Cedar store config file (YAML/JSON)")
    cedar.add_argument(
        "--backend",
        default="device",
        choices=["interpreter", "device"],
        help="authorization evaluation backend: device serves from the "
        "compiled engine on --device, interpreter from the Python "
        "interpreter only",
    )
    cedar.add_argument(
        "--device",
        default="cuda",
        help="torch device of the engine (cuda, cuda:N or cpu); the server "
        "fails at start when CUDA is asked for and absent",
    )
    cedar.add_argument(
        "--batch-window-us",
        type=float,
        default=200.0,
        help="micro-batch forming window for the fast path",
    )
    cedar.add_argument("--max-batch", type=int, default=8192, help="micro-batch row ceiling")
    cedar.add_argument(
        "--pipeline-depth",
        type=int,
        default=2,
        help="batches in flight through the three-stage evaluation "
        "pipeline (encode / dispatch / decode overlap); 0 restores the "
        "serial batch loop",
    )
    cedar.add_argument(
        "--encode-workers",
        type=int,
        default=0,
        help="host encode threads feeding the pipelined batcher (only used "
        "with --pipeline-depth > 0); 0 auto-sizes from the native encoder "
        "pool width",
    )
    cedar.add_argument(
        "--native-encode-threads",
        type=int,
        default=0,
        help="native (C++) encoder worker-pool width per batch, overriding "
        "CEDAR_NATIVE_THREADS; 0 = env var, else cpu count (capped at 16)",
    )
    cedar.add_argument(
        "--no-native",
        action="store_true",
        help="disable the C++ SAR fast path (python encode, one device "
        "evaluation per request)",
    )

    serving = parser.add_argument_group("secure serving")
    serving.add_argument("--bind-address", default=DEFAULT_ADDRESS)
    serving.add_argument("--secure-port", type=int, default=DEFAULT_PORT)
    serving.add_argument("--metrics-port", type=int, default=METRICS_PORT)
    serving.add_argument(
        "--cert-dir",
        default="/var/run/cedar-authorizer/certs",
        help="directory for (generated) serving certs",
    )
    serving.add_argument("--tls-cert-file", default="")
    serving.add_argument("--tls-private-key-file", default="")
    serving.add_argument("--insecure", action="store_true", help="serve plain HTTP (testing only)")

    resilience = parser.add_argument_group("resilience")
    resilience.add_argument(
        "--request-timeout-ms",
        type=float,
        default=2000.0,
        help="per-request deadline budget; on expiry /v1/authorize answers "
        "NoOpinion+evaluationError (0 disables)",
    )
    resilience.add_argument(
        "--shutdown-grace-seconds",
        type=float,
        default=5.0,
        help="drain window on SIGTERM: /readyz flips to 503, new requests "
        "are shed, in-flight requests get this long to finish",
    )

    debug = parser.add_argument_group("debug")
    debug.add_argument("-v", "--verbosity", type=int, default=0)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 5 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    server = build_server(args)
    server.start()

    stop = threading.Event()

    def _signal(signum, frame):
        log.info("received signal %d, shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _signal)
    signal.signal(signal.SIGINT, _signal)
    while not stop.wait(1.0):
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
