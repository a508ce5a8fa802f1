"""cedar-webhook (port): the authorization and admission webhook on the card.

    python -m cedar_tpu_torch.cli.webhook --config store-config.json --insecure

Wiring of the JAX package's cli/webhook.py for two engines and two entry
points: read the store config, build the tiered stores, and compile two
tier stacks on ``--device`` (CUDA unless ``--device cpu`` is given;
without CUDA the start fails), each into its own TorchPolicyEngine: the
authorization stack (the stores) and the admission stack (the same stores
plus the constant allow-all final tier, as the reference's
cmd/cedar-webhook/main.go:111-116 builds it). In front of each, its native
fast path and micro-batcher; the server answers ``POST /v1/authorize``
and ``POST /v1/admit`` (TLS with self-signed certs unless ``--insecure``
or cert files are given) plus the plain health and metrics server.

``--backend device`` (the default) serves from the engines;
``--backend interpreter`` serves from the Python interpreter only, with no
engine. ``--admission-fail-mode`` says what /v1/admit answers when an
evaluation fails or outlives its deadline.

Policy reload: each directory store re-reads its files every
refreshInterval (StoreConfig), and one TorchReloader polls the stores'
content generations every ``--reload-seconds``. When they change it
recompiles both engines in full, the authorization engine first; each new
plane is placed and warmed on the device and only then swapped in. A
reload that fails is logged and leaves the previous plane serving; the
next tick tries again. With ``--backend interpreter`` the tickers alone
keep the answers current. Flags of the JAX CLI that this port does not
serve (breaker, cache, fleet, tenancy, tracing, incremental compile, ...)
do not exist here, so argparse rejects them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import logging
import signal
import sys
import threading
from typing import List, Optional

from ..server.admission import CedarAdmissionHandler, allow_all_admission_policy_store
from ..server.authorizer import CedarWebhookAuthorizer
from ..server.certs import maybe_self_signed_certs
from ..server.http import DEFAULT_ADDRESS, DEFAULT_PORT, METRICS_PORT, WebhookServer
from ..server.metrics import WebhookMetrics
from ..stores.config import cedar_config_stores, parse_config
from ..stores.store import TieredPolicyStores

log = logging.getLogger(__name__)

# Loads run one at a time in the process, with the cyclic garbage
# collector paused, and what survives a load is frozen (gc.freeze)
# afterwards. A full collection walks every tracked object (the corpus
# and every compiled set) in one call that holds the interpreter lock, so
# all serving threads stop for it, and a compile allocates enough to set
# off such collections. A load makes no cyclic garbage (its old set is
# freed by reference counting), so pausing the collector loses nothing,
# and once frozen the long-lived sets are skipped by every later
# collection. After a failed load nothing is frozen: its traceback's
# cycles must stay collectable.
_load_lock = threading.Lock()


@contextlib.contextmanager
def _collector_paused():
    with _load_lock:
        enabled = gc.isenabled()
        gc.disable()
        try:
            yield
            gc.freeze()
        finally:
            if enabled:
                gc.enable()


def _fingerprint(stores: TieredPolicyStores) -> tuple:
    """Cheap change detector: each store's content generation, a counter
    bumped only on a real content change, so an unchanged tick costs a
    few method calls. A store without the counter contributes
    TieredPolicyStores.cache_generation()'s proxy, which steps when its
    policy_set() object changes."""
    return stores.cache_generation()


class TorchReloader:
    """Recompiles the engines whenever the stores' contents change.

    One reloader drives any number of (engine, tier stores) targets, in
    order, off one fingerprint of the shared dynamic stores (the
    authorization and admission stacks differ only by the constant
    allow-all tail). Each target's load is a full compile, placed and
    warmed on the device before the engine publishes it
    (TorchPolicyEngine.load with ``max_batch``). A failed load is logged,
    the target keeps its previous set, and the next tick tries it again;
    the fingerprint is kept per target, so a healthy target does not
    recompile while another keeps failing."""

    def __init__(self, stores: TieredPolicyStores, targets=None, interval_s: float = 5.0,
                 max_batch: Optional[int] = None, on_load=None):
        self.stores = stores  # the dynamic stores: fingerprint and readiness gate
        self.targets = list(targets or [])  # [(engine, tier stores)]
        self.interval_s = interval_s
        self.max_batch = max_batch  # the warm-up's top batch (engine.load)
        self.on_load = on_load  # called with each successful load's stats
        self._fps: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def reload_if_changed(self, raise_errors: bool = False) -> bool:
        """Load every target whose fingerprint is stale; True when one
        was loaded. ``raise_errors`` (the initial load) raises a failed
        load instead of logging it."""
        if not all(s.initial_policy_load_complete() for s in self.stores):
            return False
        fp = _fingerprint(self.stores)
        changed = False
        for idx, (engine, tier_stores) in enumerate(self.targets):
            if self._fps.get(idx) == fp:
                continue
            try:
                with _collector_paused():
                    stats = engine.load([s.policy_set() for s in tier_stores],
                                        max_batch=self.max_batch)
            except Exception:
                if raise_errors:
                    raise
                log.exception("engine [%d] reload failed; serving the previous set", idx)
                continue
            self._fps[idx] = fp
            changed = True
            log.info("engine [%d] loaded generation %d: %s", idx, engine.load_generation, stats)
            if self.on_load is not None:
                self.on_load(stats)
        return changed

    def run_forever(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.reload_if_changed()
            except Exception:  # noqa: BLE001 — the previous sets keep serving
                log.exception("reload failed; serving the previous compiled sets")

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, name="reloader", daemon=True)
        self._thread.start()

    def stop(self, join_timeout_s: float = 30.0) -> None:
        """Stop the polling thread, waiting up to join_timeout_s for a
        load in progress to finish."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)


def build_server(args) -> WebhookServer:
    """stores -> the authorization and admission stacks, each an engine
    loaded from its stores behind its fast path -> WebhookServer. Raises
    when the device is unavailable, a store type is not ported, or the
    native encoder or the kernels cannot be built."""
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
    # admission gets the allow-all final tier (main.go:111-116)
    admission_stores = TieredPolicyStores(
        list(stores.stores) + [allow_all_admission_policy_store()]
    )
    admission_fail_open = args.admission_fail_mode == "open"

    metrics = WebhookMetrics()
    fastpath = admission_fastpath = reloader = None
    if args.backend == "interpreter":
        if not len(stores.stores):
            log.warning("no policy stores configured; authorizer will no-opinion")
        authorizer = CedarWebhookAuthorizer(stores)
        admission_handler = CedarAdmissionHandler(
            admission_stores, allow_on_error=admission_fail_open
        )
    else:
        if not len(stores.stores):
            raise ValueError("--backend device needs at least one policy store (--config)")
        from ..engine.evaluator import TorchPolicyEngine

        engine = TorchPolicyEngine(device=args.device)
        admission_engine = TorchPolicyEngine(device=args.device)
        # every load warms its plane on the device before the swap: nvcc
        # and every first-use cost of the device paths then, not inside
        # the first requests' deadlines (the CPU's plain versions have no
        # per-shape first-use cost, so one bucket does there); the
        # warm-ups' launches count in engine.stats["warmup_launches"],
        # apart from the served launch counts
        reloader = TorchReloader(
            stores,
            targets=[(engine, stores), (admission_engine, admission_stores)],
            interval_s=args.reload_seconds,
            max_batch=args.max_batch if engine.device.type == "cuda" else 1,
            on_load=metrics.record_compile,
        )
        reloader.reload_if_changed(raise_errors=True)
        log.info("engines on %s loaded and warmed up: warm-up launches %s / %s",
                 engine.device, engine.warmup_launches, admission_engine.warmup_launches)
        authorizer = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
        admission_handler = CedarAdmissionHandler(
            admission_stores,
            allow_on_error=admission_fail_open,
            evaluate_batch=admission_engine.evaluate_batch,
        )
        if not args.no_native:
            from ..engine.fastpath import AdmissionFastPath, SARFastPath
            from ..native import set_encode_threads

            if args.native_encode_threads > 0:
                set_encode_threads(args.native_encode_threads)
            fastpath = SARFastPath(engine, authorizer)
            fastpath.prepare()
            admission_fastpath = AdmissionFastPath(admission_engine, admission_handler)
            admission_fastpath.prepare()
            log.info("native SAR and admission fast paths enabled")

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
        admission_handler=admission_handler,
        admission_fastpath=admission_fastpath,
        admission_fail_open=admission_fail_open,
        metrics=metrics,
        reloader=reloader,
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
        "--reload-seconds",
        type=float,
        default=5.0,
        help="poll interval of the reloader: when a store's content changed, "
        "both engines recompile in full and swap in their new planes",
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
        help="disable the C++ fast paths (python encode; one device "
        "evaluation per /v1/authorize request, one per admission batch)",
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
        "NoOpinion+evaluationError and /v1/admit answers the configured "
        "fail-mode (0 disables)",
    )
    resilience.add_argument(
        "--admission-fail-mode",
        default="open",
        choices=["open", "closed"],
        help="admission answer when evaluation crashes or exceeds its "
        "deadline: open allows (keeps the cluster write path alive), "
        "closed denies (nothing unevaluated is admitted)",
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
