#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cedar_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--policies 10000] [--sars 300]

Phases, each a hard failure with a nonzero exit:

  1. card: name and power limit (nvidia-smi).
  2. build: the match kernels from cedar_tpu_torch/csrc with nvcc (sm_90a),
     and beside it the native encoder (cedar_tpu_torch/native) with g++;
     prints ptxas's register and spill lines and the count of
     warpgroup-MMA instructions (IGMMA) in the library's SASS, which must
     be above 0 (the kernels run on the tensor cores).
  3. kernel parity: match_groups_kernel and match_words_kernel against
     their plain PyTorch versions on the card, bit for bit, on random
     sparse rule sets at L = 1024, R = 10240 (B in 8 / 128 / 1024 / 4096,
     G in 3 / 4 with gate / 9 for three tiers), plus ragged B, L and R
     (B = 100, 65 and 1, L = 1000 and 200, R = 10000 and 1000).
  4. serving path: a synthesized 10k-policy corpus loaded on the card;
     SubjectAccessReview bodies answered through the port's authorizer
     (launch counts reset just before, read just after: one
     match_words_kernel launch per chunk, no match_groups_kernel); every
     decision and reason set held against the port's interpreter (0
     flips); decisions/s and batch latency at batch 1 / 128 / 4096. Both
     kernels are then held against their plain versions, bit for bit, on
     the serving plane itself: the padded batch just served (its 512
     bucket) and rows of the batch-4096 traffic at B = 4096, 128, 32, 8
     and 1 (the buckets the timed batches and small requests take; below
     128 rows each is its own lit box of B rounded up to 8).
  4b. fast path: the same corpus served from raw SAR bytes through
     engine/fastpath.py SARFastPath (the C++ encoder built with g++, pinned
     staging, one asynchronous match_words_kernel launch per pipeline
     chunk, one packed D2H) over the phase's 300 bodies, its batch-4096
     bodies (512 bodies, each eight times) and 24578 more (2 new, then the
     batch-4096 bodies six times over);
     launch counts reset before and read after each batch ({words 1,
     groups 0} up to 16384 rows; at 24578 three words launches: a chunk
     of 16384, then the 8194-row tail split in two of 4097); routing
     counts (encoder_fallback held to the CPU test's count at the
     defaults); staging stats; every answer held against the authorizer
     path and, in spawned worker processes, the interpreter (0 flips;
     one interpreter answer per distinct body); decisions/s and batch
     latency at batch 1 / 128 / 4096 / 24578 beside the authorizer
     path's; the encode / device / decode split of a batch-1, a
     batch-4096 and a batch-24578 answer
     (--profile: the device's idle share and top kernels over each). Both kernels held
     against their plain versions on a native-encoded 16384-row chunk.
     Gated sub-phase: the corpus plus an interpreter-fallback and a
     native-opaque policy, 4096 rows (512 bodies, each eight times) of traffic
     that hits their scopes: gated rows re-run through evaluate_batch
     (match_groups_kernel), the rest take the words launch; 0 flips; both
     kernels held against their plain versions on that plane. The
     interpreter answers each distinct body of the phase once, in a pool
     that runs beside phase 8's server start-ups; phase 8 holds the
     phase's answers against it before its own traffic.
  5. want_full path: a set with interpreter-fallback policies (the
     coverage corpus' blowup family) served through match_groups_kernel
     (counts reset just before, read just after; match_words_kernel never
     launched), 0 flips; both kernels held against their plain versions on
     that plane and batch.
  6. diagnostics: a request matching two permits comes back through
     resolve_flagged with both reasons.
  7. timing: each kernel at the serving plane's shape (B = 4096, 128 and
     1) and at L = 1024 (B = 4096 and 128), beside its plain version, its
     bound and two library yardsticks (float32 torch.matmul, and
     torch._int_mm, the same int8 contraction without the epilogue; its
     shape rules want B > 16, so B = 1 is timed padded with zero rows to
     17). A kernel's "ms" is its wrapper called
     back to back (the host's cost per call included where it is the
     slower side); "device_ms" the same calls replayed from a CUDA graph.
     Then a rule-tile probe: match_groups_kernel's device time at B = 4096
     on both planes with the tile forced to 64, 128 and 256 rules (the
     choice cuda_match.rule_tile makes from the grid size).
  8. webhook (the /v1/authorize path): the gated sub-phase's policy set
     written to a directory with a JSON StoreConfig, and
     `python3 -m cedar_tpu_torch.cli.webhook --insecure` started on it as
     a subprocess on the card (default --device cuda, pipelined batcher);
     the expected answers from the library SARFastPath over a store built
     from the same directory, held against the interpreter's answers of
     phase 4b (decision and reason set, 0 flips); then the first 300
     gated bodies POSTed one at a time on one keep-alive connection, the
     first 2048 from 64 client threads, and the first 2048 of phase 4's
     batch-4096 synth bodies (no gated scope forced) from 64 threads (4096
     each until the offline toolchain's slice needed the time), every
     response's status equal
     to the expected one (a flip prints its body's latency and both
     answers). From the server's /debug/engine (launch counts 0 before
     the traffic: the server resets them after its start-up warm-up,
     whose launches it reports apart) and /metrics: both kernels
     launched, no fallback batch, a mean batch above 1 under 64 clients.
     Prints, per window, requests/s, p50 / p99 / first-body / max
     latency, the mean batch, the mean
     stage times per batch and the launches; the largest batch; and the
     server's peak RSS (its rusage, reaped after SIGTERM, which must end
     it with code 0 within --shutdown-grace-seconds + 5 s). Then the
     CLI's two other serving modes, each a server on the same store
     started with the first one and idle until its windows are done:
     --pipeline-depth 0 (serial batch loop; both kernels launched) and
     --no-native (one engine call per request thread), each answering
     the first 300 gated bodies from 16 clients with 0 flips and exiting
     0 on SIGTERM. No client request is retried: a reset or dropped
     connection fails the phase. --profile: then a lone request's stage
     split in this process (one thread, torch.profiler, and an
     in-process PipelinedBatcher).
  9. admission: phase 8's policy files plus
     admission policies (the forbid set of the JAX package's native
     admission tests, the repo demo's demo-require-owner-label, and an
     interpreter-fallback forbid whose scope the plane gates) in one
     directory store, and 256 seeded AdmissionReview bodies, each sent
     four times (1,024 rows; CREATE 50%,
     UPDATE 30%, DELETE 15%, CONNECT 5%; ConfigMap, Secret, Deployment and
     Pod objects; about 10% in kube-system; every sixteenth in the
     fallback forbid's scope; every 25th matching two forbids; a few
     conversion errors and one uid over 255 bytes). The expected answers
     come from the library AdmissionFastPath over the same stores plus the
     allow-all tier, held against the port's interpreter handler in the
     oracle pool (0 flips; a deny's reasons compared as a set). Then
     phase 10's server, at its version 0 (these files) and before phase
     10's traffic (phase 9 had a server of its own until phase 21 needed
     the time), serves 300 bodies on /v1/admit at concurrency 1, all 1024
     at concurrency 64, and a mixed window: 512 admission bodies from 32
     clients while 32 others POST 512 of phase 8's SAR bodies, every
     answer equal to its expected one. Over the admission-only windows
     (/debug/engine and /metrics before and after): both kernels
     launched, the admission rows routed gated, flagged, encoder_fallback
     and encoder_gate, no fallback batch, a mean batch above 1 at
     concurrency 64, and an `admission` entry in /debug/engine. Prints
     requests/s, p50 / p99, mean and largest batch, the mixed window per
     endpoint, both engines' plane shapes and the phase's wall time.
  10. live policy reload: phase 9's files in one
     directory store with refreshInterval 30s (its minimum), served by the
     CLI with --reload-seconds 1, --request-timeout-ms 10000,
     --no-incremental-compile (every reload recompiles in full) and both
     engines. While 32 clients POST
     SARs (phase 8's gated bodies) and 32 POST AdmissionReviews without
     pause, two edits land, each an atomic swap of the store's directory
     (a symlink re-pointed, as a Kubernetes ConfigMap volume updates): add
     a forbid file (every watch SAR and every admission delete), then edit
     admission.cedar (its first forbid dropped). After each,
     the phase waits for /debug/engine's load_generation to step on both
     engines (the directory ticker re-reads within 30 s, the reloader
     recompiles in full, warms the new plane on the card and swaps it in).
     The expected answers come from the oracle pool over each version's
     directory. Checks: every answer is the answer of a version live while
     the request was in flight (a request sent after an engine published
     a version gets that version's: 0 flips; a deadline expiry counts as
     a flip); each edit changed answers;
     both kernels' served launch counts rise after each swap; no fallback
     batch; the server's card memory 4 s after the second reload (the
     batches in flight at a swap hold the retired plane until they
     answer) no more than one plane above its memory 4 s after the
     first; SIGTERM ends the server
     with code 0. Prints per reload and engine the time from the write to
     the swap and the compile seconds by phase (lower, pack, place, warm);
     per endpoint requests/s and p99 in the 5 s before each write and
     while each reload compiles, and the latency of the first request sent
     after each swap; the server's card memory after reloads 1 and 2
     (nvidia-smi's per-process figure where it lists the server, and the
     server's allocator counts from /debug/engine); the phase's wall time.
     Its server runs with the breaker's trip thresholds and the
     supervisor's wedge budget at the CLI defaults, plus phase 11's
     --confirm-non-prod-inject-errors, --breaker-recovery-seconds 2 and
     --supervisor-interval-seconds 0.5, and its chaos registry disarmed.
  11. resilience, on phase 10's server once
     phase 10's checks passed, its directory at version 2: 32
     clients on /v1/authorize and 32 on /v1/admit without pause through
     four fault windows, each armed over POST /chaos/configure and
     /chaos/arm: (a) non-fatal engine.dispatch errors, disarmed once both
     breakers read open (one seam serves both engines, so a fixed count
     could trip one alone): while a path's breaker is open it forms no
     batch, with both open no kernel launches, the open breaker's answers
     have a p99 below that of the answers served in the 3 s before the
     fault (printed against 50 ms), and both close by their half-open
     probes;
     (b) the builtin device-loss scenario, disarmed once both engines'
     DeviceRecovery saw the fatal error: each rebuilds its plane on the
     card once (cedar_device_rebuilds_total 2, one per engine), both
     breakers close, both kernels launch on the rebuilt planes and, 3 s
     after, the server's allocator is within one plane of before; (c) the
     builtin
     kill-decode: the supervisor revives the dead decode stage within 2 x
     its interval of the arm; (d) the builtin store-stall: the directory
     store's next re-read stalls and serving goes on with no posture
     answer. Every answer is the expected one (the oracle's, version 2),
     or, for a request in flight during windows a-c, the failure posture
     (NoOpinion + evaluationError, the admission fail-mode with code 500)
     and in window a only until its path's breaker closed. After the
     traffic stops, both engines' staging shows 0 outstanding buffers.
     Prints per window the times to open / close / rebuild / revive,
     requests/s and p99 in the 3 s before, during and the 3 s after, the
     answer counts by kind, the rebuild's phases and the allocator before
     and after; the phase's resilience metrics and wall time; and the
     smoke's own collection pauses and, per window, the authorizations
     the server itself timed over 0.7 s. The smoke's heap
     is frozen (gc.freeze) before the traffic starts, as at every
     server's start, so that no collection of this process walks the
     earlier phases' objects inside a timed window.

  12. the CRD store with incremental reloads: a
     standard-library fake apiserver (FakeApiServer: list, watch stream,
     410) on 127.0.0.1, its kubeconfig written as JSON, serving phase
     10's policy set as Policy objects: synth_corpus(--policies, --seed)
     in objects of 10 policies (synth-0000, ...), the gated policies in
     one, the admission policies in one (L 6144 x R 10240 on both
     engines). The CLI with --kubeconfig, --reload-seconds 1,
     --request-timeout-ms 10000 and incremental compile over 64 buckets.
     32 clients POST phase 8's gated SARs and 32 AdmissionReviews
     without pause while five events go out on the watch: (1) one
     object's first policy replaced by a forbid on every list, (2) a
     one-policy object added with phase 10's forbid, (3) it deleted, (4)
     a metadata-only MODIFIED, (5) the watch streams closed and the next
     watch answered 410, so the store relists the same content. Checks:
     after each of 1-3 both engines' load_generation steps with
     compile_scope incremental, no more dirty shards than the object has
     policies (10, 1, 1), and a lower phase below a quarter of a full
     lower of the same engine's tiers, timed in the smoke's process under
     the same 32 + 32 clients just after they start (a fresh
     ShardCompiler over 64 buckets, the collector paused, as the server's
     first load lowers); after 4 and 5 no engine reloads
     within 3 reloader ticks; every answer is that of a version live while the
     request was in flight (the oracle: the port's interpreter over a CRD
     store fed the same objects; 0 flips, a deadline expiry counts as a
     flip); both kernels' served launch counts rise after each swap; no
     fallback batch, no breaker transition; the card memory 4 s after
     the third reload within one plane of 4 s after the first; SIGTERM
     ends the server with code 0. Prints per event and engine the time from the
     event to the swap, the dirty and total shards and the compile
     seconds by phase (hash, lower, pack, place, warm) beside the first
     full load's and phase 10's full reloads'; per endpoint requests/s
     and p99 in the 5 s before each event and while it compiles (after
     it, for events 4 and 5); the server's peak RSS and the phase's wall
     time.

  13. the validationMode load gate: first its
     cost, the port's analyze_tiers alone in this process over the
     corpus and both gated policies (L 6144 x R 10240 at the defaults),
     each pass timed (lower_all, lint_lowerability, find_shadowing,
     find_conflicts, capacity_report) and the whole call, with
     ``truncated`` (the pair budget is spent at 10k policies). Then two
     CLI servers, started together beside the oracle pool, the partial
     one idle while the strict one serves, each over two tiers, a
     directory store (a symlink at version 0: the corpus and the
     native-opaque forbid, refreshInterval 30s) and a CRD store on its
     own FakeApiServer with one Policy object, both
     engines incremental, --reload-seconds 1. The directory edit is one
     file with a forbid on every watch and the interpreter-fallback
     policy (a clause_limit finding, severity error). Strict
     (--validation-mode strict): the edit is rejected by both engines,
     analyzed once each (cedar_policy_analysis_findings_total counts 2
     clause_limit findings and the log 2 rejections, unchanged after
     five more reloader ticks), no load_generation steps,
     /debug/analysis names the fallback policy; the Policy object
     MODIFIED to carry the fallback policy is quarantined
     (/debug/supervisor), a MODIFIED back to its retained content leaves
     it quarantined, and a relist (a 410) clears it; no reload. Partial
     (--validation-mode partial): the same edit loads without the
     fallback policy (no fallback policy on either plane, the blocking
     finding on /debug/analysis); the gated reload's warm-up launches
     both kernels before the swap and the served words launches rise
     after it (a plane the strict or partial gate admits holds no
     interpreter-fallback policy, so no served request takes the groups
     kernel; the phase's launches are both servers' served ones plus that
     warm-up's). Every window: phase 8's first 256 gated SARs from 16 clients,
     each answer held against the port's interpreter over the tiers
     being served (version 0, or the trimmed edit: 0 flips). Prints the
     passes' seconds, every load's compile seconds with the gate's
     (``analyze``), the time from the write to the rejection or the
     swap, the gated rows per batch before and after the partial swap,
     launches, peak RSS and the phase's wall time.

  14. the decision cache: phase 12's 1,002
     Policy objects on FakeApiServer, the CLI at its cache defaults
     (--decision-cache-size 65536, TTLs 300 / 30 / 5 s), both engines
     incremental over 64 buckets, --reload-seconds 1. A working set of
     the first 512 SARs of phase 12's pool with distinct cache keys
     (gated rows included), each answer held against the interpreter
     over the tiers live at that moment (canon: decision, reason set
     with positions, error): (a) a warm pass at concurrency 64 (every
     key misses once; both kernels launch); (b) the allow keys again
     (0 misses, no launch); (c) 4 shuffled passes at concurrency 64
     (launches no more than the misses, which NoOpinion's 5 s TTL
     causes); (d) 300 allow hits at concurrency 1 (0 misses, no
     launch); (e) phase 12's event 1 while 16 clients send 256 other
     keys (every answer of a live version), until the authorization
     engine swaps; (f) the set again one request at a time, /debug/cache
     read after each: no key decided in a dirty shard, no NoOpinion or
     unscoped key and no key whose answer the edit changed answers from
     the cache, at least one other key does, 0 flips. Prints per window
     requests/s, p50 / p99, the cache counters and launches; the edit's
     event to swap, compile seconds and p99 while it compiles; the
     survivors against the keys decided in the dirty shards; the hit
     ratio, misses and coalesced totals; the server's peak RSS; and the
     host memory of a full cache (65,536 entries and memo rows,
     tracemalloc in this process).
  15. the request observability plane (this slice's main path): the CLI
     over phase 12's 1,002 Policy objects on FakeApiServer, both engines
     and the cache at its defaults, with --trace-sample-rate 1.0
     --trace-ring 4096 --trace-log-file, --audit-log-file,
     --enable-recording --recording-dir, and the artificial injector
     behind --confirm-non-prod-inject-errors at 2 errors and 3 denies per
     second (unequal rates: with equal ones both token buckets refill in
     step and the deny, consulted second, hides every error). Traffic:
     (a) 1,024 distinct-key SARs of phase 12's pool at concurrency 64 (misses)
     beside 256 admission_bodies(seed + 9) at concurrency 16; (a') 100
     other keys at concurrency 1 (misses); (b) 300 allow hits at
     concurrency 1, the keys injected in (a) first. Every 16th SAR and 8th
     review of (a) carries a traceparent. Checks, each failing the run:
     every answer held against the interpreter over the served objects,
     every difference an injected answer (NoOpinion with the injector's
     error, or its deny) whose count is the
     cedar_chaos_injections_total{seam="response"} delta (a request both
     limiters fire on answers the deny) and at most rate x window + 1 per
     kind, 0 flips; a key injected in (a) answers its real answer in (b)
     unless injected again (an injected answer is never cached); every
     answer carries X-Cedar-Trace-Id and a sampled traceparent, and a
     sent traceparent's id comes back; /debug/traces/<id> has every
     request's trace with the answer's decision: a miss's spans hold
     cache.lookup and the four batch.* spans (or coalesce.wait), a hit's
     are cache.lookup alone with 0 launches over (b), admission traces
     have path admission; the audit log has one line per answer with its
     path, decision and cached flag, its fingerprint naming a recorder
     file that holds the body; the trace log one line per kept trace,
     and python -m cedar_tpu_torch.cli.trace finds one id in it;
     /debug/slo and cedar_slo_burn_rate for both paths, the availability
     errors equal to the injected errors (and to the admission answers
     the oracle errs on); no breaker transition, supervisor restart or
     device rebuild. Prints per window requests/s, p50 and p99,
     span_tree_coverage (min, p50, p99), the median duration of each span
     of a c=1 miss and a c=1 hit, the injections, launches, the server's
     peak RSS and the phase's wall time.
  16. the overload-control plane (this slice's main path): the CLI over
     phase 12's 1,002 Policy objects on FakeApiServer, both engines, the
     cache off, the SLO tracker with --slo-latency-budget-ms 50,
     --adaptive-batching (--max-batch 64, --tuner-max-batch 4096,
     --tuner-interval-seconds 0.5, --tuner-burn-window-seconds 10). C:
     the answers a second of a 3 s closed loop at c=64 of the mix below
     without the hot user (every client below its quota), on a first
     server with these flags and no gate (--max-inflight 0), so C is
     what the server serves; the oracle runs alongside its start-up.
     The storm, on a second server with the gate, --max-inflight 64,
     and --client-qps at 5% of C: the
     port's flash_crowd_schedule (seed, base 0.5 C, peak 3 C, the crowd
     at 2 s with a 3 s ramp, 12 s) then 2 s of Poisson arrivals at the
     base; 25% kubelet SARs (system:node:node-<k>, system:nodes), 50%
     controller SARs of the SAR pool's 64 most frequent users (a third
     the first's, the hot user), 25% admission reviews of 64 service
     accounts; fired at their due times from 4 spawned asyncio processes
     (the schedule's clock starts 0.5 s after all four have started and
     connected), each on an idle keep-alive connection of a pool of 256
     per process that opens another whenever all are busy, so no arrival
     waits for an earlier answer (an overloaded server is slow to accept
     a new connection, so the pool is sized for 1,024 unanswered
     requests); /readyz polled every 100 ms. A claimed
     request's expiry feeds the breaker only while the card holds a
     batch for half the budget or longer (a starved host is not a sick
     card: its expiries answer the deadline). Checks, each
     failing the run: the driver's fire lag p99 at most 50 ms (past it
     the driver set the offered rate); the server's offered / admitted / shed / eval_shed
     and shed_by on /debug/load equal the clients' counts, offered ==
     admitted + shed, cedar_load_shed_total equals the shed answers;
     every shed the honest shape (NoOpinion + "request shed under
     overload (<reason>); retry after 1s" / the fail-open review, code
     500; Retry-After 1 at ingress); every other answer the
     interpreter's, deadlines counted apart (0 flips); no high-priority
     shed unless /readyz read saturated; at least one normal shed;
     client_quota sheds for the hot user and no other (and
     cedar_client_throttled_total's clients the same); no breaker
     transition, restart or rebuild; every tuner move inside its
     bounds; both engines warmed 1..4096 and no batch above it; both
     kernels launched. Prints C, offered and admitted requests/s, sheds
     by priority and reason, the normal share shed (all, and at the
     5-8 s peak), admitted p50 / p99 per priority and endpoint, the
     /readyz states, the tuners' moves and final knobs, the clients'
     fire lag (and of the arrivals that opened a connection), the rate
     sent at the peak (from the send times), the most requests
     unanswered at once and the connections opened, launches and the
     phase's wall time.
  17. the explain plane (this slice's main path), on phase 15's server
     once phase 15's checks passed (its cache, tracer at rate 1, audit
     log, recorder and injector all still on): phase 15's first 256
     distinct-key SARs and its first 128 AdmissionReviews POSTed with
     ?explain=1, the first 100 SARs at concurrency 1, the rest shuffled
     at concurrency 8, each answer held against phase 15's interpreter
     answers. Checks, each failing the run: 0 flips; every explanation's
     source is device, or gate with the short circuit it names (a system
     user, a skipped namespace, a review that does not convert;
     explain-error only for a body whose interpreter answer is the
     handler's own error answer, else a failed device explain); a
     device answer that allows or denies names a determining policy
     among the interpreter's reasons (an allowed review: a permit); no
     answer is the injector's; /debug/cache hits, misses and sizes, both
     kernels' served launches (/debug/engine), the injector's counts and
     the serving request counter the same before and after the window;
     no audit line carries an explain request's X-Cedar-Trace-Id, and no
     kept trace (/debug/traces/<id> 404, the trace log unchanged); one
     new recorder file per explain body, holding it;
     cedar_explain_requests_total per path equal to what was sent,
     cedar_explain_compiles_total 0; both breakers closed. Prints the
     latency p50 / p99 and requests/s at concurrency 1 and 8 with the
     server's and this process's CPU per request (/proc), the gates
     met and the launches. Then serving beside explain: bare SARs on
     keys the cache never saw, 16 at concurrency 1 and 128 at 64, once
     alone and once beside an explain loop at concurrency 8 (serving
     p50 / p99 and requests/s in each). Then, in this process on phase
     4's engine (the same 10k corpus; with --only-explain a fresh load
     of it): one request's split, encode, the bits fetch (CUDA events;
     host time beside it) and build_explanation, medians over 50
     requests; and explain with no HTTP layer from 1 and 8 threads, from
     8 with a 0.5 ms switch interval, with one explain at a time and
     with one bits fetch at a time (requests/s, CPU and each part's host
     time per request), then 8 threads under torch.profiler
     (the ops' and CUDA runtime calls' count and host time per request,
     the card's busy share).
  18. the shadow rollout (this slice's main path), on phase 15's server
     after phase 17 (started with --rollout-control-token-file; the
     shadow at its defaults: sample rate 1, queue 1024, duty cycle 0.1).
     A lifecycle POST without the token and with a wrong one answers
     403, promote when idle 409. Under --only-rollout, the first of four
     live-cost windows (misses on fresh keys: 400 at c=1, then 2000 at
     c=64), with no candidate staged. Then the candidate: phase
     12's objects again as candidate-labelled copies (cand-<name>), the
     permits of the first 20 synth objects turned forbids, the two
     interpreter-fallback policies left out (the strict stage gate
     refuses them) and phase 10's flip file added, applied on
     FakeApiServer (the store withholds them from live serving); POST
     /rollout/stage {"crd": true} compiles both candidate engines and
     they warm up to the live engines' top bucket. The shadow window:
     192 fresh SARs and 48 reviews in two chunks (768 and 192 until
     phase 21 needed the time, 384 and 96 until the offline toolchain's
     slice did; SARs at c=12,
     reviews at c=4), each drained before the next, so nothing sheds:
     the report's counts per class (and its exemplars' classes) equal
     those the port's interpreter gives over the live and candidate
     corpora (the oracle pool), evaluations + skipped = offered, no
     candidate error, and the shadow worker's candidate launches
     include match_words_kernel (a strict-gated candidate has no
     interpreter-fallback policy, so match_groups_kernel runs in its
     warm-up, not its shadow evaluations). Under --only-rollout, two
     live-cost windows beside the shadow at its default duty cycle
     (evaluations + shed + skipped = offered once it drained), the
     candidate discarded (rollback while staged: 200, idle), the last
     window alone, and the candidate staged again; the windows' answers
     are held against the interpreter after the last window, and the
     medians of the two windows alone and the two beside are printed (a
     whole run says the cost was not measured). Promote: the next
     answer and a window of 192 SARs (c=16) and 48 reviews equal the
     candidate oracle's; no warm-up launch on either live engine, one
     native encoder built per path, at the adoption. Roll back: the same
     window equals the live oracle's; nothing built or warmed. Every
     answer of every window is checked (an injected one apart, counted
     against the injector's metrics). Prints stage-to-ready and each
     candidate engine's compile and warm seconds, each swap's POST time and
     first answer's latency, the launches (served and the shadow's), the
     server's RSS at the phase's end (its peak over phases 15, 17 and 18
     is phase 15's line after the SIGTERM) and the phase's wall time.
  19. the declarative lifecycle (this slice's main path), after phase 16:
     (b) first, while (a)'s server starts: the device-exact sweep of
     phase 4's engine (analysis/semdiff.py sweep with engine= and the
     engine's pack, the rule bitsets fetched on the card) equals the
     host sweep over the same pack (dead, shadowed, overlaps,
     match_counts; 0 oracle disagreements on either), and its sat matrix
     _host_sat_matrix's byte for byte; both times printed. (a) a server
     over phase 12's objects without their two interpreter-fallback
     policies (one directory store, a file per object; cache off),
     --rollout-insecure-control, a journal file, the audit log,
     --profiling and --lifecycle-spec-dir with two specs (empty canary
     ladders): tenant-breach, a directory candidate holding an
     interpreter-fallback policy under lowerability_floor_pct 100, must
     halt at verifying and end rolled_back with nothing staged;
     tenant-good, the live set plus one permit for a user no traffic
     sends, with the analyze gate on (that user an allowed intent,
     flip budget 0), shadow min_samples 128 and diff budget 0, manual
     promotion. Two clients send a pool of 384 distinct SARs throughout;
     /debug/lifecycle is polled (analyzing, shadowing and promoted seen
     in order, each with its evidence); one /debug/pprof/profile is
     taken while the candidate shadows (its top three stacks printed);
     once tenant-good awaits approval, POST /lifecycle/approve, then the
     promotion and 2 s more traffic. Checks: the journal holds every
     transition of both walks (pending -> verifying -> analyzing ->
     shadowing -> promoting -> promoted, with one awaiting_approval and
     one approved record; pending -> verifying -> halted -> rolled_back),
     /metrics cedar_lifecycle_stage reads 5 and 7, the analyze evidence
     0 oracle disagreements and 0 out-of-intent flips, the shadow 256
     samples and 0 diffs, the audit log one rollout stage
     (lifecycle:tenant-good), and every answer equals the port's
     interpreter over the set live when it was served (before the
     approval the live set, after the promotion the candidate, either
     between; the oracle pool after the server stopped). Prints the
     analyze gate's seconds and universe, stage to ready, the shadow's
     samples a second, approve to the first answer of the promoted set,
     the launches (served, the shadow worker's, the candidate engines'
     warm-ups: launches_lifecycle) and the phase's wall time. (c) only
     under --only-lifecycle: the embedded canary router (an in-process
     RolloutController over phase 4's engine, the 10 / 50 / 100 ladder,
     a clean candidate promoted then rolled back, then the
     lifecycle-breach game day halting a second rollout on its canary
     SLO burn, every served answer the live engine's) and a crash
     resume (a server killed while its rollout shadows; a new one on the
     same journal restarts it from pending and walks it to shadowing).
  20. the multi-tenant shared plane (this slice's main path), after phase
     19, at the JAX bench's tenant setting: synth_tenant_corpora(1000,
     10, seed=17, clusters=2), ten tenants of 1,000 policies, each a
     directory with one file per policy (tenant-03 also holds the
     interpreter-fallback policy), behind the CLI with ten --tenant
     flags, a --tenant-host, the decision cache on and --validation-mode
     permissive. While the server starts: the interpreter's answers of
     every body over its tenant's own directory (the oracle pool), the
     same ten tenants fused into a card engine in this process (the
     parsed corpora, each policy named and ordered as its directory store
     serves it) and two tenants' standalone card engines over their
     directories, and both kernels held against
     their plain versions on the fused plane's own operands (native codes
     of every tenant's bodies, each row stamped with its tenant's code).
     Then: c=1 library calls of the fused and the standalone engines;
     c=1 over HTTP per tenant (16 fresh SARs each); 480 fresh SARs at
     c=64, tenants interleaved; from 8 clients, tenants interleaved,
     each tenant's 64 SARs (tenant-00's first 16 through the
     x-cedar-tenant header, tenant-09's through Host) and 16 reviews, and
     a SAR aimed at each tenant's org-wide policies sent to it and to its
     neighbor; an unknown and a missing tenant on both endpoints. Checks:
     every answer equals the interpreter's over that tenant's own
     directory (0 flips); at least 32 org-wide bodies answered
     differently by their two tenants; the standalone engines' answers
     equal the served ones (decision and reason set); the refusals answer
     "tenant rejected: ..." (a denied review, code 403, on /v1/admit),
     launch nothing and count on cedar_tenant_rejected_total{reason};
     cedar_tenant_requests_total equals what each tenant was sent. Then
     one policy of tenant-05 (one that alone decides a body of its
     traffic) flips effect on disk: both engines reload with 1 dirty
     shard, under tenant-05's prefix and in the shards.tenants rollup;
     every other tenant's decided entry answers from the cache; every
     SAR again, 0 stale (tenant-05's held to the edited directory's
     interpreter). Both kernels launched by the served traffic. Prints
     ready seconds, c=1 p50 / p99 per tenant (HTTP) and fused against
     standalone (library), c=64 requests/s and mean batch, event to
     swap, the server's card memory (its allocator's peak) and the
     phase's launches and wall time.
  21. the PDP front end (this slice's main path), after phase 20: one
     policy file of MeshCorpus(--policies, seed + 21), the three
     vocabularies of the JAX bench's mesh scenario (k8s resource permits,
     http:<method> permits over NonResourceURL paths and avp:<action>
     permits, 34 / 33 / 33, every policy distinct) plus an
     interpreter-fallback policy in the http:post vocabulary and one that
     reads a declared context header; behind the CLI with --pdp-listen on
     a free port, a --pdp-schema that declares that header (tuple cap
     64), the decision cache on, --validation-mode permissive and an
     audit log. While the server starts, the PdpOracle's answer of every
     distinct body (the oracle pool). Then: the fail postures (an
     unmappable check 403, an unparseable body and an over-cap body 400,
     a malformed tuple answered for itself beside answered neighbours);
     64 fresh ext_authz checks at c=1 (the joiners' POSTs take the gated
     lane), then 64 fresh SARs at c=1 (none gated); a mixed window of
     2,048 SARs from 32 webhook clients, 2,048 checks from 32 ext_authz
     clients and 64 batch bodies of 32 tuples from 4 clients at once,
     every draw Zipf-skewed over its principal pool; one check and the
     SAR of the same bytes, each sent twice. Checks: every answer equals
     the PdpOracle's (0 flips); a formed batch's protocol_mix signature
     holds all three protocols (/debug/engine); the twin bodies miss
     twice, then hit their own entries; cedar_authorizer_request_total
     by protocol and the audit lines by protocol equal what was sent; no
     PDP body classifies high, while kubelet-named checks would as SARs;
     the c=1 SARs launch no match_groups_kernel and the c=1 checks do;
     both kernels launched, gated rows routed; no breaker transition,
     supervisor restart or device rebuild. Prints ready seconds, c=1 p50
     / p99 of checks and SARs, the mixed window's requests/s and p50 /
     p99 per protocol with batch POSTs' tuples/s, the mean batch and the
     protocol_mix tallies, the server's allocator peak, launches and the
     phase's wall time.

Phases 8, 9, 10, 12 and 13 also check that /metrics shows no breaker
transition, no supervisor restart and no device rebuild, and so do
14, 15, 16, 19 and 20. Every server runs at the CLI's observability defaults, as
users deploy it: tracing armed at sample rate 0 (slow, errored and
posture-answered requests tail-kept) and the SLO tracker on; phase 15
arms the rest. Every server of phases 8-13 runs with --decision-cache-size 0:
they measure the device path and the breaker's posture, which cached
answers would bypass. Every server of phases 8-12 gates its loads with
the config's default validationMode (permissive): each load's compile
seconds carry the gate's ``analyze`` phase.

``--only-reload`` runs phases 1, 2 and 10 alone (a quick check of the
reload phase), ``--only-resilience`` phases 1, 2, 10 and 11,
``--only-crd`` phases 1, 2 and 12, ``--only-gate`` phases 1, 2 and 13,
``--only-cache`` phases 1, 2 and 14, ``--only-obs`` phases 1, 2 and 15,
``--only-load`` phases 1, 2 and 16, ``--only-explain`` phases 1, 2, 15
and 17, ``--only-rollout`` phases 1, 2, 15 and 18, and
``--only-lifecycle`` phases 1, 2 and 19 (with 19 (c), and a 10k engine
of its own for (b)), ``--only-tenancy`` phases 1, 2 and 20, and
``--only-pdp`` phases 1, 2 and 21; none prints result lines.

Prints the card line, then one {"kernels": [...]} line, then, last,
{"ok": true, "device": {...}}. In the kernels line each kernel carries
its launches on every path the run drove as ``launches_<path>``, each
counted from 0 just before that path and read just after (phase 17's
explain window launches neither kernel by design: ``launches_explain``
is 0; ``launches_rollout`` adds the shadow worker's launches on the
candidate engines to the server's served ones, and
``launches_lifecycle`` those and the candidate engines' warm-ups;
``launches_tenancy`` phase 20's server's served ones, ``launches_pdp``
phase 21's);
``launches`` is their sum. The run's wall time is printed before the
card line. Exits nonzero, printing no result, when
CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

INT32_MAX = 2**31 - 1
# published H100 SXM peaks (700 W): HBM bytes/s and dense int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of one fn() over `iters` back-to-back calls (CUDA
    events, after warm-up; inputs stay L2-resident as in steady serving)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_gmma_count(lib_path) -> dict:
    """Warpgroup-MMA instructions in the built library's SASS, by opcode
    (IGMMA is the integer one), from the toolkit's cuobjdump."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    ops = {}
    for line in out.stdout.splitlines():
        for tok in line.replace(";", " ").split():
            if "GMMA" in tok:
                op = tok.split(".")[0]
                ops[op] = ops.get(op, 0) + 1
    return ops


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of one fn() with the host out of the way: `iters` calls
    captured in one CUDA graph and replayed once (CUDA events). fn's
    allocations come from the graph's pool; its launches are counted once,
    at capture."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_plane(torch, rng, L, R, G, n_pad=0):
    """Sparse random rules (mostly 2-3 positive literals, a few with one,
    occasional negation) so a row matches a handful of rules: groups with
    no, one and several matched policies all occur. The last n_pad columns
    are padding (thresh 1e9, policy INT32_MAX). On the card as the kernels
    take them: W is the [L_pad, R] view of the K-major plane Wt [R, L_pad]
    (L padded to a multiple of 64 with zero columns, as for a hand-built
    plane)."""
    from cedar_tpu_torch.engine.weights import k_major_plane

    W = np.zeros((L, R), np.int8)
    n_pos = rng.choice([1, 2, 3], size=R, p=[0.05, 0.6, 0.35])
    for k in range(3):
        cols = np.nonzero(n_pos > k)[0]
        W[rng.integers(0, L, size=cols.size), cols] = 1
    neg = np.nonzero(rng.random(R) < 0.3)[0]
    neg_rows = rng.integers(0, L, size=neg.size)
    keep = W[neg_rows, neg] == 0
    W[neg_rows[keep], neg[keep]] = -1
    thresh = np.maximum((W > 0).sum(0), 1).astype(np.int32)
    group = rng.integers(0, G, size=R).astype(np.int32)
    policy = rng.integers(0, 20000, size=R).astype(np.int32)
    if n_pad:
        thresh[-n_pad:] = 10**9
        group[-n_pad:] = 0
        policy[-n_pad:] = INT32_MAX
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return dev(k_major_plane(W)).t(), dev(thresh), dev(group), dev(policy)


def random_lit(torch, rng, B, L, active=24):
    """[B, L_pad] literal matrix: `active` literals below L per row, zero
    tail."""
    from cedar_tpu_torch.engine.weights import padded_literals

    idx = rng.integers(0, L, size=(B, active))
    lit = np.zeros((B, padded_literals(L)), np.int8)
    np.put_along_axis(lit, idx, 1, axis=1)
    return torch.from_numpy(lit).cuda()


# the policy texts of the JAX package's server fast-path tests that the
# native plane gates: an interpreter-fallback policy (an alternation
# product past the lowering's clause ceiling) and a native-opaque one (an
# extension call on a request value, which only the Python encoder
# evaluates)
FALLBACK_POLICY = (
    'permit (principal in k8s::Group::"joiners", '
    'action == k8s::Action::"get",\n'
    "        resource is k8s::Resource)\n"
    "  when { "
    + " && ".join(
        '(resource.resource == "widgets" || resource.name == "10.0.0.1")'
        for _ in range(12)
    )
    + " };\n"
)
NATIVE_OPAQUE_POLICY = """
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""

# encoder_fallback rows of each fast-path batch at the defaults (--seed 0
# --policies 10000 --sars 300): tests/test_torch_fastpath.py computes the
# same counts on the CPU from the same seeded corpus
EXPECTED_ENCODER_FALLBACK = {"300": 0, "4096": 0, "24578": 0}


def gated_policy_set(corpus):
    """The synth corpus with the two gated policies appended."""
    from cedar_tpu_torch.lang import PolicySet

    extra = PolicySet.from_source(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY, "gated")
    return PolicySet(list(corpus.policies) + extra.policies())


def gated_bodies(corpus, n: int, seed: int) -> list:
    """n synth SAR bodies, every eighth replaced by one that hits a gated
    scope (joiners reading widgets; deletecollection with an ip-like or
    other name)."""
    out = corpus.sar_bodies(n, seed=seed)
    hits = [
        {"user": "jo", "groups": ["joiners"], "verb": "get", "resource": "widgets", "name": nm}
        for nm in ("10.0.0.1", "x", "")
    ] + [
        {"user": u, "groups": [], "verb": "deletecollection", "resource": "pods", "name": nm}
        for u in ("sam", "c0-user-1") for nm in ("127.0.0.1", "10.0.0.1", "not-an-ip")
    ]
    for k, i in enumerate(range(0, n, 8)):
        h = hits[k % len(hits)]
        ra = {"verb": h["verb"], "version": "v1", "resource": h["resource"], "namespace": "c0-ns-0"}
        if h["name"]:
            ra["name"] = h["name"]
        out[i] = json.dumps({
            "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": {"user": h["user"], "uid": "u", "groups": h["groups"], "resourceAttributes": ra},
        }).encode()
    return out


# admission policies of phase 9: the forbid set of the JAX package's
# native admission tests (tests/test_admission_native.py ADM_POLICIES)
ADM_POLICIES = """
forbid (
    principal,
    action == k8s::admission::Action::"create",
    resource is core::v1::ConfigMap
) when {
    resource.metadata has labels &&
    resource.metadata.labels.contains({key: "env", value: "prod"})
};
forbid (
    principal in k8s::Group::"tenants",
    action in [k8s::admission::Action::"update", k8s::admission::Action::"delete"],
    resource is core::v1::Secret
) when {
    resource.metadata has namespace &&
    resource.metadata.namespace == "protected"
};
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is apps::v1::Deployment
) when {
    resource has spec && resource.spec has replicas &&
    resource.spec.replicas > 50
};
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is core::v1::ConfigMap
) when {
    context has oldObject && context.oldObject has metadata &&
    context.oldObject.metadata has namespace &&
    context.oldObject.metadata.namespace == "locked"
};
forbid (
    principal is k8s::ServiceAccount,
    action in k8s::admission::Action::"all",
    resource is core::v1::Pod
) when {
    resource.spec has hostNetwork && resource.spec.hostNetwork == true
};
"""
# the repo demo's demo-require-owner-label (demo/admission-policy.yaml),
# inline: the card may have no PyYAML
ADM_DEMO_OWNER_POLICY = """
forbid (
    principal is k8s::User in k8s::Group::"tenants",
    action == k8s::admission::Action::"create",
    resource is core::v1::ConfigMap
) unless {
    resource.metadata has labels &&
    resource.metadata.labels.contains({ key: "owner", value: principal.name })
};
"""
# an admission-scoped interpreter-fallback forbid (an alternation product
# past the lowering's clause ceiling, as the JAX package's hybrid admission
# test builds it): true in the "default" namespace, so a service account's
# create there is denied through the gated exact path
ADM_FALLBACK_POLICY = (
    "forbid (principal is k8s::ServiceAccount,\n"
    '        action == k8s::admission::Action::"create",\n'
    "        resource is core::v1::ConfigMap)\n"
    "  when { "
    + " && ".join(
        '(resource.metadata.namespace == "default" || resource.metadata.name == "zzz")'
        for _ in range(12)
    )
    + " };\n"
)
ADM_GATED_USER = "system:serviceaccount:default:ci-runner"


def _adm_object(rng, kind: str, i: int, ns: str) -> dict:
    """A realistic object of `kind`: metadata with labels and annotations,
    and the kind's data, spec and status."""
    labels = rng.choice([
        None, {}, {"app": f"svc-{i % 7}"}, {"app": f"svc-{i % 7}", "env": rng.choice(["dev", "prod"])},
        {"owner": rng.choice(["bob", "alice", "ci-bot"]), "team": "a"},
    ])
    meta = {"name": f"{kind.lower()}-{i}", "namespace": ns, "uid": f"obj-{i:06d}",
            "resourceVersion": str(1000 + i), "creationTimestamp": "2026-01-01T00:00:00Z"}
    if labels is not None:
        meta["labels"] = labels
    if rng.random() < 0.3:
        meta["annotations"] = {"kubectl.kubernetes.io/last-applied-configuration": "{}",
                               "note": f"n{i % 5}"}
    obj = {"apiVersion": "apps/v1" if kind == "Deployment" else "v1", "kind": kind,
           "metadata": meta}
    if kind == "ConfigMap":
        obj["data"] = {f"key{j}": f"value-{i}-{j}" for j in range(rng.randint(0, 5))}
    elif kind == "Secret":
        obj["type"] = "Opaque"
        obj["data"] = {"username": "YWRtaW4=", "password": "c2VjcmV0"}
    elif kind == "Deployment":
        sel = {"app": f"svc-{i % 7}"}
        obj["spec"] = {
            "replicas": rng.choice([1, 2, 3, 50, 51, 200]),
            "selector": {"matchLabels": sel},
            "template": {"metadata": {"labels": sel}, "spec": {"containers": [{
                "name": "app", "image": f"registry.example/app:{i % 9}",
                "ports": [{"containerPort": 8080}],
                "resources": {"limits": {"cpu": "500m", "memory": "256Mi"}}}]}},
        }
        obj["status"] = {"replicas": 2, "readyReplicas": rng.choice([0, 1, 2])}
    else:  # Pod
        obj["spec"] = {
            "hostNetwork": rng.random() < 0.2,
            "nodeSelector": {"disk": rng.choice(["ssd", "hdd"])},
            "serviceAccountName": "default",
            "containers": [{"name": "app", "image": f"registry.example/app:{i % 9}",
                            "args": ["--port", "8080"]}],
        }
        obj["status"] = {"phase": rng.choice(["Pending", "Running"]),
                         "podIP": rng.choice(["10.0.3.7", "fe80::1", "not-an-ip"]),
                         "hostIP": "192.168.1.20"}
    return obj


def admission_bodies(n: int, seed: int) -> list:
    """n seeded AdmissionReview bodies (module docstring, phase 9): the
    operation and kind mix, the kube-system share, and the rows that take
    each route (gated, flagged multi-forbid, encoder fallback)."""
    rng = random.Random(seed)
    kinds = {"ConfigMap": ("", "configmaps"), "Secret": ("", "secrets"),
             "Deployment": ("apps", "deployments"), "Pod": ("", "pods")}
    users = ["alice", "bob", "ci-bot", "system:serviceaccount:team-a:deployer",
             "system:node:node-1"]
    out = []
    for i in range(n):
        # the forced rows below are creates: these weights keep the whole
        # mix near CREATE 50%, UPDATE 30%, DELETE 15%, CONNECT 5%
        op = rng.choices(["CREATE", "UPDATE", "DELETE", "CONNECT"], weights=[44, 33, 17, 6])[0]
        kind = rng.choice(list(kinds))
        ns = "kube-system" if rng.random() < 0.11 else rng.choice(
            ["default", "protected", "locked", "team-a"])
        user = rng.choice(users)
        groups = rng.choice([[], ["tenants"], ["tenants", "dev"], ["system:authenticated"]])
        sub = ""
        if i % 16 == 3:  # the fallback forbid's scope: a gated row
            op, kind, user, groups = "CREATE", "ConfigMap", ADM_GATED_USER, []
            ns = rng.choice(["default", "team-a"])
        elif i % 25 == 7:  # two forbids match: a flagged (multi) row
            op, kind, user, groups, ns = "CREATE", "ConfigMap", "bob", ["tenants"], "default"
        group, resource = kinds[kind]
        if op == "CONNECT":
            kind, group, resource, sub = "PodExecOptions", "", "pods", "exec"
            obj = {"apiVersion": "v1", "kind": kind, "container": "app", "stdin": True,
                   "tty": rng.random() < 0.5,
                   "command": rng.choice([["/bin/sh"], ["ls", "-l"], ["cat", "/etc/hosts"]])}
        else:
            obj = _adm_object(rng, kind, i, ns)
        if i % 25 == 7:
            obj["metadata"]["labels"] = {"env": "prod", "app": "web"}
        old = None
        if op in ("UPDATE", "DELETE"):
            old = json.loads(json.dumps(obj))
            old["metadata"]["namespace"] = rng.choice([ns, "locked"])
            if kind == "Deployment":
                old["spec"]["replicas"] = 3
        req = {
            "uid": f"adm-{seed}-{i:06d}",
            "kind": {"group": group, "version": "v1", "kind": kind},
            "resource": {"group": group, "version": "v1", "resource": resource},
            "name": obj.get("metadata", {}).get("name", f"pod-{i}"), "namespace": ns,
            "operation": op,
            "userInfo": {"username": user, "uid": f"uid-{user}", "groups": groups},
            "dryRun": False,
        }
        if sub:
            req["subResource"] = sub
        if rng.random() < 0.1:
            req["userInfo"]["extra"] = {"scopes": ["read", "write"]}
        if op != "DELETE":
            req["object"] = obj
        if old is not None:
            req["oldObject"] = old
        # conversion errors (the Python path answers allow-on-error) and a
        # uid longer than the encoder's 255-byte passback
        if i % 97 == 11:
            req["object"] = dict(obj, weight=1.5)  # a float leaf
            req["operation"] = "CREATE"
        elif i % 97 == 43:
            req["operation"] = "EVICT"
        elif i % 97 == 77:
            req["operation"] = "CREATE"
            req.pop("object", None)
        elif i == 5:
            req["uid"] = "u" * 300
        out.append(json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                               "request": req}).encode())
    return out


def canon(resp):
    """A SAR response with its reason list as a set: what must agree
    between paths (the order of several reasons is not a contract)."""
    st = dict(resp["status"])
    if st["reason"]:
        doc = json.loads(st["reason"])
        st["reason"] = sorted(
            json.dumps(r, sort_keys=True) for r in doc.get("reasons", [])
        )
    return st


_ORACLES: dict = {}
_ORACLE_ARGS: dict = {}


def _oracle_init(n_policies: int, seed: int, adm_dir=None) -> None:
    """Worker initializer: what the oracles are built from (each is built
    at its first use in the worker)."""
    _ORACLE_ARGS.update(n_policies=n_policies, seed=seed, adm_dir=adm_dir)


def _oracle(name: str):
    """The port's interpreter over the serving corpus ("synth"), its gated
    twin ("gated"), or, for "admission", the interpreter admission handler
    over phase 9's directory plus the allow-all tier; "dir-authorize:<dir>"
    and "dir-admit:<dir>" name the authorizer and the admission handler
    over a directory store of <dir> (phase 10's versions);
    "crd-authorize:<file>" and "crd-admit:<file>" the same over a CRD
    store fed the Policy objects listed in the JSON <file> (phase 12's
    versions: the policy ids are the served ones); "cand-authorize:<file>"
    and "cand-admit:<file>" over the rollout candidate those objects stage
    (rollout/: ids <object>.policy<N>, the admission stack with the
    allow-all tier); "pdp:<dir>" the PDP front end's PdpOracle over a
    directory store of <dir> (phase 21), whose bodies come as (protocol,
    bytes) pairs."""
    if name not in _ORACLES:
        from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

        if name.startswith("pdp:"):
            from cedar_tpu_torch.pdp import PdpOracle
            from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

            _ORACLES[name] = PdpOracle(TieredPolicyStores([
                DirectoryPolicyStore(name[len("pdp:"):], start_ticker=False)]))
        elif name.startswith("gate-authorize:"):
            _ORACLES[name] = _tiered_oracle(name[len("gate-authorize:"):])
        elif name.startswith("cand-"):
            from cedar_tpu_torch.apis.v1alpha1 import PolicyObject
            from cedar_tpu_torch.rollout.controller import candidate_stores
            from cedar_tpu_torch.rollout.source import candidate_tiers_from_objects
            from cedar_tpu_torch.server.admission import CedarAdmissionHandler
            from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer

            kind, path = name[len("cand-"):].split(":", 1)
            with open(path) as f:
                objs = [PolicyObject.from_dict(d) for d in json.load(f)]
            authz_stores, adm_stores = candidate_stores(candidate_tiers_from_objects(objs))
            _ORACLES[name] = (CedarAdmissionHandler(adm_stores) if kind == "admit"
                              else CedarWebhookAuthorizer(authz_stores))
        elif name.startswith("crd-"):
            from cedar_tpu_torch.server.admission import (
                CedarAdmissionHandler,
                allow_all_admission_policy_store,
            )
            from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
            from cedar_tpu_torch.stores.crd import CRDPolicyStore

            kind, path = name[len("crd-"):].split(":", 1)
            with open(path) as f:
                store = CRDPolicyStore(source=_ListedObjects(json.load(f)))
            while not store.initial_policy_load_complete():
                time.sleep(0.01)
            store.close()
            if kind == "admit":
                _ORACLES[name] = CedarAdmissionHandler(TieredPolicyStores(
                    [store, allow_all_admission_policy_store()]))
            else:
                _ORACLES[name] = CedarWebhookAuthorizer(TieredPolicyStores([store]))
        elif name.startswith("dir-"):
            from cedar_tpu_torch.server.admission import (
                CedarAdmissionHandler,
                allow_all_admission_policy_store,
            )
            from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
            from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

            kind, path = name[len("dir-"):].split(":", 1)
            store = DirectoryPolicyStore(path, start_ticker=False)
            if kind == "admit":
                _ORACLES[name] = CedarAdmissionHandler(TieredPolicyStores(
                    [store, allow_all_admission_policy_store()]))
            else:
                _ORACLES[name] = CedarWebhookAuthorizer(TieredPolicyStores([store]))
        elif name == "admission":
            from cedar_tpu_torch.server.admission import (
                CedarAdmissionHandler,
                allow_all_admission_policy_store,
            )
            from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

            _ORACLES[name] = CedarAdmissionHandler(TieredPolicyStores([
                DirectoryPolicyStore(_ORACLE_ARGS["adm_dir"], start_ticker=False),
            allow_all_admission_policy_store()]))
        else:
            from cedar_tpu_torch.corpus.synth import synth_corpus
            from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer

            corpus = synth_corpus(_ORACLE_ARGS["n_policies"], seed=_ORACLE_ARGS["seed"])
            ps = corpus.tiers()[0] if name == "synth" else gated_policy_set(corpus)
            _ORACLES[name] = CedarWebhookAuthorizer(TieredPolicyStores([MemoryStore(name, ps)]))
    return _ORACLES[name]


class _ListedObjects:
    """A CRD store's watch source over fixed Policy object documents: its
    list answers them, its watch waits for the store to stop."""

    def __init__(self, docs: list):
        self.docs = docs

    def list(self):
        from cedar_tpu_torch.apis.v1alpha1 import PolicyObject

        return [PolicyObject.from_dict(d) for d in self.docs]

    def watch(self, on_event, stop):
        stop.wait()


def admission_oracle(handler, body: bytes) -> dict:
    """The interpreter's AdmissionReview response for one raw body, with
    the webhook's answers to a body that does not decode (400) or a review
    that does not convert (allow-on-error)."""
    from cedar_tpu_torch.entities.admission import AdmissionRequest, review_request_uid
    from cedar_tpu_torch.server.admission import AdmissionResponse

    try:
        review = json.loads(body)
    except ValueError as e:
        return AdmissionResponse(uid="", allowed=False, code=400,
                                 error=f"failed parsing body: {e}").to_admission_review()
    try:
        return handler.handle(AdmissionRequest.from_admission_review(review)).to_admission_review()
    except Exception as e:  # noqa: BLE001 — every body gets an answer
        return AdmissionResponse(uid=review_request_uid(review), allowed=True,
                                 error=f"evaluation error (allowed on error): {e}"
                                 ).to_admission_review()


def adm_key(resp: dict) -> tuple:
    """An admission response with a deny's reason list as a set: what must
    agree with the interpreter (the engine lists the device plane's
    reasons before the interpreter-fallback policies', the interpreter in
    policy order; the served answers equal the expected ones byte for
    byte)."""
    msg = resp["status"]["message"]
    if msg.startswith("[{"):
        msg = sorted(json.dumps(r, sort_keys=True) for r in json.loads(msg))
    return resp["uid"], resp["allowed"], resp["status"]["code"], msg


def _oracle_answers(task):
    from cedar_tpu_torch.server.sar import get_authorizer_attributes, sar_response

    name, bodies = task
    if name.startswith("pdp:"):
        from cedar_tpu_torch.pdp import PdpBody

        oracle = _oracle(name)
        return [canon(sar_response(*oracle.authorize_body(PdpBody(b, proto) if proto else b)))
                for proto, b in bodies]
    if name == "admission" or name.startswith(("dir-admit:", "crd-admit:", "cand-admit:")):
        return [admission_oracle(_oracle(name), b) for b in bodies]
    attrs = [get_authorizer_attributes(json.loads(b)) for b in bodies]
    return [canon(sar_response(d, r)) for d, r in _oracle(name).authorize_batch(attrs)]


def interpreter_answers(tasks: dict, n_policies: int, seed: int, adm_dir=None,
                        piece: int = 512) -> dict:
    """{label: (oracle name, bodies)} -> {label: [answer]} from the port's
    interpreter (canon SAR responses; admission response documents),
    spread in pieces of `piece` bodies over one spawned worker per core
    (it takes milliseconds per request at 10k policies); the pool is torn
    down before returning."""
    return interpreter_answers_started(tasks, n_policies, seed, adm_dir, piece)()


def interpreter_answers_started(tasks: dict, n_policies: int, seed: int, adm_dir=None,
                                piece: int = 512):
    """interpreter_answers with its pool started now and read later: ->
    a function that waits for the answers, tears the pool down and
    returns them."""
    import multiprocessing as mp

    work = [(label, i, name, bodies[i:i + piece])
            for label, (name, bodies) in tasks.items() for i in range(0, len(bodies), piece)]
    n_workers = max(1, min(os.cpu_count() or 1, len(work)))
    pool = mp.get_context("spawn").Pool(
        n_workers, initializer=_oracle_init, initargs=(n_policies, seed, adm_dir))
    pending = pool.map_async(_oracle_answers, [(name, b) for _, _, name, b in work],
                             chunksize=1)

    def collect() -> dict:
        try:
            answers = pending.get()
        finally:
            pool.terminate()
            pool.join()
        out = {label: [] for label in tasks}
        for (label, _, _, _), ans in zip(work, answers):
            out[label].extend(ans)
        return out

    return collect


def profile_answer(torch, fn, label: str) -> None:
    """One call of fn under torch.profiler: the device's busy and idle
    share of its wall time and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kern = {}  # device-side events only (ops would count twice), summed
    launches = 0  # by the first 60 characters of their names
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kern[ev.key[:60]] = kern.get(ev.key[:60], 0.0) + ev.self_device_time_total
            launches += ev.count
    busy = sum(kern.values()) / 1e6
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {label}: wall {wall:.4f} s, device busy {busy:.6f} s, "
          f"idle share {1 - busy / wall:.4f}, {launches} device kernels and copies; "
          "top device time (us): "
          + json.dumps({k: round(v, 1) for k, v in top}), flush=True)


def reason_key(status: dict, rename: dict) -> tuple:
    """(allowed, denied, evaluationError, sorted policy ids) of a SAR
    response status, raw or canon()'d; ids mapped through `rename` (a
    directory store names a policy <file>.policy<N>)."""
    reason = status["reason"]
    if isinstance(reason, list):
        reasons = [json.loads(r) for r in reason]
    elif reason.startswith("{"):
        reasons = json.loads(reason).get("reasons", [])
    else:
        reasons = [{"policy": reason}]
    ids = sorted(rename.get(r["policy"], r["policy"]) for r in reasons)
    return status["allowed"], status["denied"], status.get("evaluationError"), ids


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


class Client:
    """One keep-alive connection to the webhook; post() -> (answer,
    seconds): a SAR's status on /v1/authorize, an AdmissionReview's
    response on /v1/admit; the response's headers stay in `headers`. A
    request that fails in any way (a reset or dropped connection, a
    non-200 answer) raises: nothing is retried."""

    def __init__(self, port: int, path: str = "/v1/authorize", whole: bool = False):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.path = path
        # whole: post() answers the whole document (an explain answer's
        # explanation beside its status or response)
        self.key = None if whole else "response" if path == "/v1/admit" else "status"
        self.headers: dict = {}

    def post(self, body: bytes, headers=None):
        t = time.perf_counter()
        self.conn.request("POST", self.path, body=body,
                          headers={"Content-Type": "application/json", **(headers or {})})
        resp = self.conn.getresponse()
        data = resp.read()
        dt = time.perf_counter() - t
        self.headers = dict(resp.getheaders())
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        if resp.will_close:
            raise RuntimeError("the webhook closed a keep-alive connection")
        doc = json.loads(data)
        return (doc if self.key is None else doc[self.key]), dt

    def close(self):
        self.conn.close()


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


class ClientPauses:
    """This process's own cyclic collections: (unix start, seconds,
    generation) of every full collection and of any other that took 5 ms
    or more. A collection holds the interpreter lock, so every client
    thread of the smoke stops for it, and a request in flight then reads
    the pause as the server's latency. main() installs it."""

    def __init__(self):
        self.events: list = []
        self._start = None

    def install(self) -> None:
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info) -> None:
        if phase == "start":
            self._start = (time.time(), time.perf_counter())
        elif self._start is not None:
            t, p = self._start
            self._start = None
            dt = time.perf_counter() - p
            if info["generation"] == 2 or dt >= 0.005:
                self.events.append((t, dt, info["generation"]))

    def between(self, a: float, b: float) -> list:
        """The collections that started in [a, b) (unix seconds)."""
        return [e for e in self.events if a <= e[0] < b]


CLIENT_GC = ClientPauses()


def freeze_client_heap() -> tuple:
    """Collect, then freeze (gc.freeze), everything this process holds,
    so that no later collection walks it: the corpus, the phase-4 engine
    and the earlier phases' answers make a full collection of this heap
    take on the order of a second, and one that fell inside a timed
    window stalled all of the window's clients at once. Called where no
    client runs (a server's start, a phase's set-up). Returns (seconds of
    that collection, objects frozen by this call)."""
    frozen = gc.get_freeze_count()
    t = time.perf_counter()
    gc.collect()
    took = time.perf_counter() - t
    gc.freeze()
    return took, gc.get_freeze_count() - frozen


def cache_bytecode() -> None:
    """Cache the bytecode of every Python process the smoke starts from
    here on (each server, oracle worker and storm client imports torch and
    the port) under the checkout's build directory. Where the environment
    sets PYTHONDONTWRITEBYTECODE, as the card machine's does, each of them
    would otherwise compile those sources anew, some seconds of every
    server start. Nothing is written outside the checkout; spawned workers
    inherit -B and only read what the servers wrote."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cedar_tpu_torch",
                          "_build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


def diag_key(decision, diag):
    """Decision and reason set: what must agree with the interpreter
    (error message texts differ by design: the device plane reports
    "evaluation error")."""
    return decision, sorted(r.policy for r in diag.reasons)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policies", type=int, default=10000)
    ap.add_argument("--sars", type=int, default=300)
    ap.add_argument("--only-reload", action="store_true",
                    help="run phases 1, 2 and 10 only (a quick check of the reload phase); "
                         "prints no result lines")
    ap.add_argument("--only-resilience", action="store_true",
                    help="run phases 1, 2, 10 and 11 only (phase 11 runs on phase 10's "
                         "server); prints no result lines")
    ap.add_argument("--only-crd", action="store_true",
                    help="run phases 1, 2 and 12 only (the CRD store with incremental "
                         "reloads); prints no result lines")
    ap.add_argument("--only-gate", action="store_true",
                    help="run phases 1, 2 and 13 only (the validationMode load gate); "
                         "prints no result lines")
    ap.add_argument("--only-cache", action="store_true",
                    help="run phases 1, 2 and 14 only (the decision cache); prints no "
                         "result lines")
    ap.add_argument("--only-obs", action="store_true",
                    help="run phases 1, 2 and 15 only (the observability plane); prints "
                         "no result lines")
    ap.add_argument("--only-load", action="store_true",
                    help="run phases 1, 2 and 16 only (the overload-control plane under a "
                         "flash crowd); prints no result lines")
    ap.add_argument("--only-explain", action="store_true",
                    help="run phases 1, 2, 15 and 17 only (the explain plane on phase 15's "
                         "server); prints no result lines")
    ap.add_argument("--only-rollout", action="store_true",
                    help="run phases 1, 2, 15 and 18 only (the shadow rollout on phase 15's "
                         "server); prints no result lines")
    ap.add_argument("--only-lifecycle", action="store_true",
                    help="run phases 1, 2 and 19 only (the declarative lifecycle, with the "
                         "embedded canary router and a crash resume); prints no result lines")
    ap.add_argument("--only-tenancy", action="store_true",
                    help="run phases 1, 2 and 20 only (ten tenants fused into one pair of card "
                         "engines behind the tenant front end); prints no result lines")
    ap.add_argument("--only-pdp", action="store_true",
                    help="run phases 1, 2 and 21 only (the PDP front end: SAR, ext_authz and "
                         "batch-authorize traffic on one server); prints no result lines")
    ap.add_argument("--profile", action="store_true",
                    help="trace one batch-4096 answer of the authorizer path and "
                         "a batch-1, a batch-4096 and a batch-24578 answer of the fast path "
                         "with torch.profiler and print the device's busy and "
                         "idle share; after phase 8, split a lone request's time over "
                         "the pipeline stages in-process")
    args = ap.parse_args()
    t_smoke = time.monotonic()
    CLIENT_GC.install()

    def clock(phase: str) -> None:
        """Where a phase starts on the run's clock (the phases' shares of
        the run's wall time)."""
        print(f"run clock: phase {phase} starts at {time.monotonic() - t_smoke:.1f} s",
              flush=True)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        from cedar_tpu_torch.corpus.synth import coverage_corpus, synth_corpus
        from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
        from cedar_tpu_torch.lang import PolicySet
        from cedar_tpu_torch.ops import cuda_match
        from cedar_tpu_torch.ops import match as plain
        from cedar_tpu_torch.server.authorizer import (
            CedarWebhookAuthorizer,
            record_to_cedar_resource,
        )
        from cedar_tpu_torch.server.sar import get_authorizer_attributes, sar_response
        from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores
    except ImportError as e:
        fail(f"the cedar_tpu_torch package is not importable here: {e}")
    cache_bytecode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    kinds = {
        "match_groups_kernel": {
            "route": "cuda",
            "source": "cedar_tpu_torch/csrc/match.cu",
            "replaces": "cedar_tpu/ops/pallas_match.py:276",
        },
        "match_words_kernel": {
            "route": "cuda",
            "source": "cedar_tpu_torch/csrc/match.cu",
            "replaces": "cedar_tpu/ops/pallas_match.py:361",
        },
    }

    # ---- 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)

    # ---- 2. build: nvcc, and beside it the native encoder's g++ (4b and
    # every server load it)
    from cedar_tpu_torch.native import build as native_build

    t0 = time.monotonic()
    native = {"fresh": not native_build.library_path().is_file()}

    def build_native():
        try:
            native_build.ensure_built()
        except Exception as e:  # noqa: BLE001 — raised again below
            native["error"] = e
        native["s"] = time.monotonic() - t0

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    lib = cuda_match.build()
    print(f"build: {lib.relative_to(cuda_match.BUILD_ROOT.parent.parent)} "
          f"in {time.monotonic() - t0:.2f} s", flush=True)
    native_thread.join()
    so = native_build.ensure_built()  # raises the build's error, if any
    cmd = " ".join(native_build.compile_command(native_build.glue_include(), so.name))
    print(f"native build (beside nvcc): {cmd} in {native['s']:.2f} s"
          + ("" if native["fresh"] else " (already built)"), flush=True)
    for line in cuda_match.build_log().splitlines():
        if "ptxas info" in line and ("Compiling entry" in line or "Used" in line) \
                or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    gmma = sass_gmma_count(lib)
    print(f"sass: warpgroup-MMA instructions {json.dumps(gmma)}", flush=True)
    if gmma.get("IGMMA", 0) < 1:
        fail("the built library has no IGMMA instruction: the kernels do not use "
             "the int8 tensor cores")

    if args.only_crd:
        corpus = synth_corpus(args.policies, seed=args.seed)
        crd_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6))
        return
    if args.only_gate:
        corpus = synth_corpus(args.policies, seed=args.seed)
        gate_phase(args, card, corpus, gated_bodies(corpus, 4096, seed=args.seed + 6))
        return
    if args.only_cache:
        corpus = synth_corpus(args.policies, seed=args.seed)
        cache_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6))
        return
    if args.only_obs:
        corpus = synth_corpus(args.policies, seed=args.seed)
        obs_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6))
        return
    if args.only_load:
        corpus = synth_corpus(args.policies, seed=args.seed)
        load_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6))
        return
    if args.only_explain:
        corpus = synth_corpus(args.policies, seed=args.seed)
        obs_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6),
                  then=explain_then(args, card, corpus=corpus))
        return
    if args.only_rollout:
        corpus = synth_corpus(args.policies, seed=args.seed)
        obs_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6),
                  then=rollout_then(args, card, corpus))
        return
    if args.only_lifecycle:
        corpus = synth_corpus(args.policies, seed=args.seed)
        tiers = corpus.tiers()
        engine = TorchPolicyEngine()
        engine.load(tiers)
        lifecycle_phase(args, card, corpus, engine, tiers)
        return
    if args.only_pdp:
        pdp_phase(args, card)
        return
    if args.only_reload or args.only_resilience:
        corpus = synth_corpus(args.policies, seed=args.seed)
        reload_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6),
                     then=resilience_then(args, card) if args.only_resilience else None)
        return

    clock("3")
    # ---- 3. kernel parity (launches here are not main-path launches)
    err = {"match_groups_kernel": 0, "match_words_kernel": 0}

    n_sm = cuda_match.sm_count(0)

    def parity(label, lit, W, th, grp, pol, T, gate, need_mix, maps=None):
        """Both kernels against their plain versions on the same inputs,
        bit for bit; folds the error into err and fails on any difference.
        maps: the plane's TMA map cache, as the engine passes it."""
        G = plain.n_groups_of(T, gate)
        (B, L), R = lit.shape, W.shape[1]
        f_k, l_k = cuda_match.match_groups(lit, W, th, grp, pol, G, plane_maps=maps)
        f_p, l_p = plain.first_match_ref(lit, W, th, grp, pol, G)
        w_k = cuda_match.match_words(lit, W, th, grp, pol, T, gate, plane_maps=maps)
        w_p = plain.tier_walk(f_p, l_p, T, gate)
        torch.cuda.synchronize()
        e_g = max(
            int((f_k.long() - f_p.long()).abs().max()),
            int((l_k.long() - l_p.long()).abs().max()),
        )
        # words compared as the uint32 values they encode
        e_w = int(((w_k.long() & 0xFFFFFFFF) - (w_p.long() & 0xFFFFFFFF)).abs().max())
        err["match_groups_kernel"] = max(err["match_groups_kernel"], e_g)
        err["match_words_kernel"] = max(err["match_words_kernel"], e_w)
        matched = int((f_p != INT32_MAX).sum())
        multi = int(((f_p != l_p) & (f_p != INT32_MAX)).sum())
        print(f"parity {label} B={B} L={L} R={R} G={G} rule tile "
              f"{cuda_match.rule_tile(B, R, n_sm)}: groups err {e_g}, words err {e_w} "
              f"({B * G - matched} empty / {matched - multi} single / {multi} multi "
              "groups)", flush=True)
        if e_g or e_w:
            fail(f"kernel disagrees with its plain version ({label} B={B} L={L} R={R} G={G})")
        if need_mix and (not multi or matched == multi or matched == B * G):
            fail(f"parity case {label} B={B} G={G} did not exercise empty, single "
                 "and multi groups")

    if args.only_tenancy:
        tenancy_phase(args, card, parity)
        return

    cases = [(B, 1024, 10240, T, gate) for B in (8, 128, 1024, 4096)
             for T, gate in ((1, False), (1, True), (3, False))]
    cases += [(100, 1024, 10000, 1, True), (100, 1000, 10000, 3, False),
              (65, 1000, 10000, 1, True), (1, 200, 1000, 1, False)]
    t0 = time.monotonic()
    for B, L, R, T, gate in cases:
        G = plain.n_groups_of(T, gate)
        W, th, grp, pol = random_plane(torch, rng, L, R, G, n_pad=R // 20)
        lit = random_lit(torch, rng, B, L)
        parity("random", lit, W, th, grp, pol, T, gate, need_mix=B >= 128)
    print(f"parity: {len(cases)} random cases exact in {time.monotonic() - t0:.1f} s",
          flush=True)

    clock("4")
    # ---- 4. serving path: 10k-policy corpus, SAR bodies -> authorizer
    t0 = time.monotonic()
    corpus = synth_corpus(args.policies, seed=args.seed)
    tiers = corpus.tiers()
    engine = TorchPolicyEngine()
    if engine.device.type != "cuda":
        fail(f"engine chose {engine.device}, not cuda")
    stats = engine.load(tiers)
    cs = engine.compiled_set
    if cs.Wt_dev.device.type != "cuda" or cs.Wt_dev.dtype != torch.int8 \
            or not cs.Wt_dev.is_contiguous() or tuple(cs.Wt_dev.shape) != (cs.R, cs.L):
        fail("compiled plane is not a K-major int8 tensor [R, L] on the card")
    print(f"serving: {args.policies} policies -> L={cs.L} R={cs.R} "
          f"rules={cs.n_rules} "
          f"G={cs.n_groups} fallback={len(cs.fallback)}; corpus+load "
          f"{time.monotonic() - t0:.1f} s ({stats['compile_seconds']})", flush=True)
    if cs.fallback:
        fail("the serving corpus must lower fully (no interpreter fallback)")
    stores = TieredPolicyStores([MemoryStore("synth", tiers[0])])
    authz = CedarWebhookAuthorizer(
        stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch
    )
    oracle = CedarWebhookAuthorizer(stores)  # the port's interpreter
    bodies = corpus.sar_bodies(args.sars, seed=args.seed + 1)

    def answer(authorizer, batch):
        attrs = [get_authorizer_attributes(json.loads(b)) for b in batch]
        return [sar_response(d, r) for d, r in authorizer.authorize_batch(attrs)]

    flagged0 = engine.flagged_rows
    cuda_match.reset_launch_counts()
    got = answer(authz, bodies)
    torch.cuda.synchronize()
    serving_launches = cuda_match.launch_counts()
    want = answer(oracle, bodies)
    flips = sum(canon(a) != canon(b) for a, b in zip(got, want))
    allow = sum(r["status"]["allowed"] for r in got)
    deny = sum(r["status"]["denied"] for r in got)
    print(f"serving: {len(bodies)} SARs, {allow} allow / {deny} deny / "
          f"{len(bodies) - allow - deny} no-opinion, flagged rows "
          f"{engine.flagged_rows - flagged0}, flips vs interpreter: {flips}", flush=True)
    print(f"serving launches: {serving_launches}", flush=True)
    if flips:
        fail(f"{flips} decisions differ from the interpreter")
    # one batch of fewer than 32768 rows: one words launch, nothing else
    if serving_launches != {"match_groups_kernel": 0, "match_words_kernel": 1}:
        fail(f"the serving path should launch match_words_kernel once: {serving_launches}")
    if allow == 0 or allow == len(bodies):
        fail("serving traffic did not exercise both allow and non-allow answers")

    from cedar_tpu_torch.compiler.table import encode_request_codes

    def engine_lit(eng, c_s, items_, pad):
        """The literal matrix the engine builds for these items (padded to
        its batch bucket when pad), with the codes and extras."""
        enc_ = [encode_request_codes(c_s.packed.plan, c_s.packed.table, em, rq)
                for em, rq in items_]
        c, e = eng._encode_batch_arrays(c_s, enc_, len(enc_))
        if pad:
            c, e = eng._pad_to_bucket(c, e, c_s.L)
        return c, e, plain.lit_matrix_codes(
            eng._to_device(c), eng._to_device(e), c_s.act_rows_dev)

    # parity at the serving plane's shapes: the padded batch phase 4 served
    # (its bucket), and rows of the batch-4096 traffic at every bucket the
    # timed batches below and small requests take
    serve_plane = (cs.W_dev, cs.thresh_dev, cs.rule_group_dev, cs.rule_policy_dev,
                   cs.n_tiers, cs.has_gate)
    items300 = [record_to_cedar_resource(get_authorizer_attributes(json.loads(b)))
                for b in bodies]
    _, _, lit300 = engine_lit(engine, cs, items300, pad=True)
    parity("serving", lit300, *serve_plane, need_mix=False, maps=cs.plane_maps)
    # the batch-4096 traffic: 512 bodies, each eight times (4096 distinct
    # until phase 21 needed the time, 2048 twice until the offline
    # toolchain's slice did: the interpreter answers each body once)
    big = corpus.sar_bodies(512, seed=args.seed + 2) * 8
    items4096 = [record_to_cedar_resource(get_authorizer_attributes(json.loads(b)))
                 for b in big]
    codes, extras, serve_lit = engine_lit(engine, cs, items4096, pad=False)
    for B in (4096, 128, 32, 8, 1):
        parity("serving", serve_lit[:B].contiguous(), *serve_plane, need_mix=False,
               maps=cs.plane_maps)

    perf = {}
    for batch, reps in ((1, 20), (128, 5), (4096, 2)):
        lat = []
        for i in range(reps):
            lo = (i * batch) % 4096
            chunk = big[lo:lo + batch]
            t = time.perf_counter()
            answer(authz, chunk)
            lat.append(time.perf_counter() - t)
        med = float(np.median(lat))
        perf[batch] = {"batch_latency_ms": med * 1e3, "decisions_per_s": batch / med}
    print("serving throughput (SAR JSON -> SAR response, host clock, "
          f"{card}): " + json.dumps(perf), flush=True)

    # where one batch-4096 answer's time goes (host clock; every stage
    # ends on the host, so device work is included where it runs)
    split = {}
    t = time.perf_counter()
    attrs = [get_authorizer_attributes(json.loads(b)) for b in big]
    split["json_to_attributes"] = time.perf_counter() - t
    t = time.perf_counter()
    items = [record_to_cedar_resource(a) for a in attrs]
    split["entities"] = time.perf_counter() - t
    t = time.perf_counter()
    enc = [encode_request_codes(cs.packed.plan, cs.packed.table, em, rq) for em, rq in items]
    codes, extras = engine._encode_batch_arrays(cs, enc, len(enc))
    split["encode"] = time.perf_counter() - t
    t = time.perf_counter()
    words, _ = engine.match_arrays(codes, extras, cs=cs)
    split["device_match"] = time.perf_counter() - t
    t = time.perf_counter()
    resolved = engine.resolve_flagged(words, codes, extras, cs=cs)
    verdicts = [
        resolved[i] if i in resolved else engine._finalize_packed(cs, int(words[i]))
        for i in range(len(words))
    ]
    split["resolve_and_decode"] = time.perf_counter() - t
    t = time.perf_counter()
    [sar_response(*authz._map_verdict(d, dg)) for d, dg in verdicts]
    split["render"] = time.perf_counter() - t
    total = sum(split.values())
    print("batch 4096 split (host clock, s): " + json.dumps(
        {k: round(v, 6) for k, v in split.items()}) + f" total {total:.4f}", flush=True)
    if args.profile:
        profile_answer(torch, lambda: answer(authz, big), "batch 4096")

    clock("4b")
    # ---- 4b. the native fast path: raw SAR bytes -> C++ encoder -> pinned
    # staging -> one words launch per chunk -> one packed D2H
    from cedar_tpu_torch.engine.fastpath import SARFastPath, _chunk_sizes

    fast = SARFastPath(engine, authz)
    # the largest batch: 24578 rows, the fewest past one chunk whose tail
    # splits (65536 until phase 13 needed the time, 32768 until phase 18
    # did); its last 24576 rows are the batch-4096 bodies six times over
    # (once until phase 19 needed the time, four times until phase 20
    # did), so the interpreter answers 2 new bodies for it (every answer
    # served is still held against the interpreter; the card test of the
    # fast path's launches serves 65536)
    big_n = 24578
    big_rows = corpus.sar_bodies(big_n - 6 * len(big), seed=args.seed + 5) + big * 6
    batches = {"300": bodies, "4096": big, str(big_n): big_rows}
    # one words launch per pipeline chunk: 16384-row chunks, a last one
    # above 8192 rows split in two halves (the JAX package's chunk plan),
    # so 24578 rows are 16384 + 4097 + 4097, three launches
    want_words = {label: len(_chunk_sizes(len(b), fast._CHUNK, fast._TAIL_CHUNK))
                  for label, b in batches.items()}
    fast_answers, fast_launches = {}, {}
    defaults = (args.seed, args.policies, args.sars) == (0, 10000, 300)
    for label, batch in batches.items():
        before = dict(fast.routing)
        cuda_match.reset_launch_counts()
        res = fast.authorize_raw(batch)
        torch.cuda.synchronize()
        fast_launches[label] = cuda_match.launch_counts()
        routing = {k: fast.routing[k] - before[k] for k in before}
        fast_answers[label] = [canon(sar_response(*r)) for r in res]
        print(f"fastpath batch {label}: launches {fast_launches[label]}, routing "
              f"{json.dumps(routing)}, stages (s) "
              f"{json.dumps({k: round(v, 6) for k, v in fast.last_stage_s.items()})}", flush=True)
        if fast_launches[label] != {"match_groups_kernel": 0,
                                    "match_words_kernel": want_words[label]}:
            fail(f"fast path batch {label}: launches {fast_launches[label]}, want "
                 f"{want_words[label]} match_words_kernel and no match_groups_kernel")
        if defaults and routing["encoder_fallback"] != EXPECTED_ENCODER_FALLBACK[label]:
            fail(f"fast path batch {label}: {routing['encoder_fallback']} encoder_fallback "
                 f"rows, the CPU test counts {EXPECTED_ENCODER_FALLBACK[label]}")
    authz_answers = {"300": [canon(r) for r in got]}
    for label in ("4096", str(big_n)):
        authz_answers[label] = [canon(r) for r in answer(authz, batches[label])]
    for label in batches:
        flips = sum(a != b for a, b in zip(fast_answers[label], authz_answers[label]))
        print(f"fastpath batch {label}: flips vs the authorizer path {flips}", flush=True)
        if flips or len(fast_answers[label]) != len(batches[label]):
            fail(f"fast path batch {label}: {flips} answers differ from the authorizer path")
    print(f"staging: {json.dumps(engine.staging_stats())}", flush=True)

    # both kernels on the fast path's own operands: native codes of a
    # 16384-row chunk (its bucket), pinned-staged and expanded on the card
    snap = fast._current_snapshot()
    c16, e16, _n16, f16 = snap.encoder.encode_batch(big_rows[:16384])
    if not (f16 == 0).all():
        fail("the 16384-row parity chunk holds rows the encoder did not pass")
    c16, e16 = engine._pad_to_bucket(c16, e16, cs.L)
    lit16k = plain.lit_matrix_codes(engine._to_device(c16), engine._to_device(e16),
                                    cs.act_rows_dev)
    parity("fastpath", lit16k, *serve_plane, need_mix=False, maps=cs.plane_maps)

    def fast_answer(batch):
        return [sar_response(*r) for r in fast.authorize_raw(batch)]

    fperf = {}
    for batch, reps in ((1, 20), (128, 10), (4096, 5), (big_n, 3)):
        row = {}
        for path, fn, n_reps in (("fastpath", fast_answer, reps),
                                 ("authorizer", lambda b: answer(authz, b),
                                  1 if batch == big_n else reps)):
            lat = []
            for i in range(n_reps):
                lo = (i * batch) % big_n
                chunk = big_rows[lo:lo + batch]
                t = time.perf_counter()
                fn(chunk)
                lat.append(time.perf_counter() - t)
            med = float(np.median(lat))
            row[path] = {"batch_latency_ms": med * 1e3, "decisions_per_s": batch / med}
        fperf[batch] = row
    print("fastpath throughput vs the authorizer path (SAR JSON -> SAR response, host "
          f"clock, {card}): " + json.dumps(fperf), flush=True)
    for label, batch in (("1", big[:1]), ("4096", big), (str(big_n), big_rows)):
        fast.authorize_raw(batch)
        print(f"fastpath batch {label} stages (host clock, s, {card}): " + json.dumps(
            {k: round(v, 6) for k, v in fast.last_stage_s.items()}), flush=True)
        if args.profile:
            profile_answer(torch, lambda: fast_answer(batch), f"fastpath batch {label}")

    # gated sub-phase: the corpus with an interpreter-fallback and a
    # native-opaque policy; rows in their scopes re-run through
    # evaluate_batch (want_full: match_groups_kernel), the rest stay native
    g_ps = gated_policy_set(corpus)
    g_engine = TorchPolicyEngine()
    g_engine.load([g_ps])
    gcs = g_engine.compiled_set
    if not (gcs.fallback and gcs.has_gate):
        fail("the gated set should carry interpreter-fallback policies and gate rules")
    g_authz = CedarWebhookAuthorizer(
        TieredPolicyStores([MemoryStore("gated", g_ps)]), evaluate_batch=g_engine.evaluate_batch)
    g_fast = SARFastPath(g_engine, g_authz)
    # 2048 bodies, each twice, as the batch-4096 traffic above
    g_batch = gated_bodies(corpus, 512, seed=args.seed + 6) * 8
    cuda_match.reset_launch_counts()
    g_res = g_fast.authorize_raw(g_batch)
    torch.cuda.synchronize()
    gated_launches = cuda_match.launch_counts()
    g_answers = [canon(sar_response(*r)) for r in g_res]
    g_flips = sum(a != canon(b) for a, b in zip(g_answers, answer(g_authz, g_batch)))
    print(f"fastpath gated: {len(gcs.fallback)} fallback policies, G={gcs.n_groups}, "
          f"launches {gated_launches}, routing {json.dumps(g_fast.routing)}, flips vs the "
          f"authorizer path {g_flips}", flush=True)
    if g_fast.routing["gated"] < 1:
        fail("no row of the gated traffic was gated")
    if gated_launches["match_groups_kernel"] < 1 or gated_launches["match_words_kernel"] < 1:
        fail(f"gated traffic should launch both kernels: {gated_launches}")
    if g_flips:
        fail(f"gated traffic: {g_flips} answers differ from the authorizer path")
    g_snap = g_fast._current_snapshot()
    gc, ge, _gn, gf = g_snap.encoder.encode_batch(g_batch)
    ok = gf == 0
    gc, ge = g_engine._pad_to_bucket(gc[ok], ge[ok], gcs.L)
    g_lit = plain.lit_matrix_codes(g_engine._to_device(gc), g_engine._to_device(ge),
                                   gcs.act_rows_dev)
    parity("gated", g_lit, gcs.W_dev, gcs.thresh_dev, gcs.rule_group_dev,
           gcs.rule_policy_dev, gcs.n_tiers, gcs.has_gate, need_mix=False,
           maps=gcs.plane_maps)

    # every answer of the phase against the port's interpreter, which
    # answers each distinct body once; in pieces of 128 (a piece of 512
    # takes about 20 s at 10k policies, so the last of some 65 left the
    # other workers idle that long). The pool starts with phase 8's
    # servers (their start-ups overlap it; phases 5-7 time the kernels
    # on an otherwise idle host), and phase 8 reads it before it holds
    # its expected answers against the gated ones
    synth = list(dict.fromkeys(b for batch in batches.values() for b in batch))
    gated = list(dict.fromkeys(g_batch))

    def check_4b(collect, t0: float, batches=batches, fast_answers=fast_answers,
                 g_answers=g_answers, g_batch=g_batch, synth=synth, gated=gated) -> list:
        """The interpreter's answers -> every 4b answer held against
        them (0 flips); returns the gated batch's. Its inputs are bound
        here: phase 7 reuses some of these names."""
        oracle_answers = collect()
        by_body = dict(zip(synth, oracle_answers["synth"]))
        wants = {label: [by_body[b] for b in batch] for label, batch in batches.items()}
        by_gated = dict(zip(gated, oracle_answers["gated"]))
        wants["gated"] = [by_gated[b] for b in g_batch]
        for label, mine in list(fast_answers.items()) + [("gated", g_answers)]:
            flips = sum(a != b for a, b in zip(mine, wants[label]))
            print(f"fastpath {label}: flips vs the interpreter {flips}", flush=True)
            if flips or len(mine) != len(wants[label]):
                fail(f"fast path {label}: {flips} answers differ from the interpreter")
        print(f"interpreter check (phase 4b, beside phase 8's start-up): "
              f"{sum(map(len, wants.values()))} answers of "
              f"{sum(map(len, oracle_answers.values()))} distinct bodies in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        return wants["gated"]

    clock("5")
    # ---- 5. want_full path: interpreter-fallback policies
    cov = coverage_corpus(per_family=4, base=64, seed=args.seed)
    fb_engine = TorchPolicyEngine()
    fb_engine.load(cov.tiers())
    if not fb_engine.compiled_set.fallback:
        fail("coverage corpus produced no interpreter-fallback policy")
    items = cov.items(256, seed=args.seed + 3)
    words_calls = []
    real_words = cuda_match.match_words

    def spy(*a, **k):
        words_calls.append(1)
        return real_words(*a, **k)

    cuda_match.match_words = spy
    cuda_match.reset_launch_counts()
    try:
        res = fb_engine.evaluate_batch(items)
        torch.cuda.synchronize()
    finally:
        cuda_match.match_words = real_words
    full_launches = cuda_match.launch_counts()
    ps = cov.tiers()[0]
    fb_flips = sum(
        diag_key(*r) != diag_key(*ps.is_authorized(em, req)) for r, (em, req) in zip(res, items)
    )
    print(f"want_full: {len(fb_engine.compiled_set.fallback)} fallback policies, "
          f"{len(items)} requests, launches {full_launches}, flips {fb_flips}", flush=True)
    if fb_flips:
        fail(f"want_full path: {fb_flips} answers differ from the interpreter")
    if words_calls:
        fail("want_full path took the words-only launch")
    if full_launches["match_groups_kernel"] < 1 or full_launches["match_words_kernel"]:
        fail(f"want_full path should launch match_groups_kernel only: {full_launches}")
    fcs = fb_engine.compiled_set
    _, _, fb_lit = engine_lit(fb_engine, fcs, items, pad=True)
    parity("want_full", fb_lit, fcs.W_dev, fcs.thresh_dev, fcs.rule_group_dev,
           fcs.rule_policy_dev, fcs.n_tiers, fcs.has_gate, need_mix=False,
           maps=fcs.plane_maps)

    clock("6")
    # ---- 6. diagnostics: two permits match one request
    src = """
permit (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal, action == k8s::Action::"delete", resource is k8s::Resource)
  when { resource.resource == "pods" };
"""
    d_engine = TorchPolicyEngine()
    d_engine.load([PolicySet.from_source(src, "diag")])
    body = {"spec": {"user": "sam", "uid": "u", "resourceAttributes": {
        "verb": "get", "resource": "pods", "version": "v1", "namespace": "default"}}}
    em, req = record_to_cedar_resource(get_authorizer_attributes(body))
    decision, diag = d_engine.evaluate(em, req)
    want_d = diag_key(*PolicySet.from_source(src, "diag").is_authorized(em, req))
    print(f"diagnostics: {decision} reasons {[r.policy for r in diag.reasons]} "
          f"flagged rows {d_engine.flagged_rows}", flush=True)
    if diag_key(decision, diag) != want_d or len(diag.reasons) != 2 or d_engine.flagged_rows != 1:
        fail("the two-permit request did not come back through resolve_flagged with both reasons")

    clock("7")
    # ---- 7. timing at the main path's shapes
    # the serving plane's literal matrix for the batch-4096 SARs above
    # (held against the plain versions in phase 4)
    S = cs.packed.table.n_slots
    print(f"serving lit: [{serve_lit.shape[0]}, {serve_lit.shape[1]}] from {S} slots, "
          f"{float(serve_lit.float().sum(1).mean()):.1f} active literals per row", flush=True)
    # each plane with its TMA map cache, as the engine keeps it
    planes = {"serving": (serve_lit, cs.W_dev, cs.thresh_dev, cs.rule_group_dev,
                          cs.rule_policy_dev, cs.n_tiers, cs.has_gate, (4096, 128, 1),
                          cs.plane_maps)}
    W1, th1, g1, p1 = random_plane(torch, rng, 1024, 10240, 3, n_pad=10240 // 20)
    planes["L1024"] = (random_lit(torch, rng, 4096, 1024), W1, th1, g1, p1, 1, False,
                       (4096, 128), {})
    shapes = {k: [] for k in kinds}
    for plane_name, (lit_all, W, th, grp, pol, T, gate, batches, maps) in planes.items():
        G = plain.n_groups_of(T, gate)
        L, R = W.shape
        Wf = W.float()
        for B in batches:
            lit = lit_all[:B].contiguous()
            litf = lit.float()
            iters = 20 if B == 4096 else 100
            lib_ms = time_ms(torch, lambda: torch.matmul(litf, Wf), iters)
            # the same int8 contraction, without the epilogue; cuBLASLt's
            # rules want more than 16 rows, so a smaller batch is timed
            # padded with zero rows to the 17 it accepts
            int_mm_rows = max(B, 17)
            lit_mm = lit if B == int_mm_rows else torch.cat(
                [lit, lit.new_zeros((int_mm_rows - B, lit.shape[1]))])
            int_mm_ms = None
            try:
                int_mm_ms = time_ms(torch, lambda: torch._int_mm(lit_mm, W), iters)
            except RuntimeError as e:
                print(f"torch._int_mm refused B={int_mm_rows} L={L} R={R}: {e}", flush=True)
            rows = {
                "match_groups_kernel": (
                    lambda: cuda_match.match_groups(lit, W, th, grp, pol, G, plane_maps=maps),
                    lambda: plain.first_match_ref(lit, W, th, grp, pol, G),
                    2 * 4 * B * G,
                ),
                "match_words_kernel": (
                    lambda: cuda_match.match_words(lit, W, th, grp, pol, T, gate,
                                                   plane_maps=maps),
                    lambda: plain.match_words_ref(lit, W, th, grp, pol, T, gate),
                    4 * B,
                ),
            }
            for k, (kernel_fn, plain_fn, out_bytes) in rows.items():
                ms = time_ms(torch, kernel_fn, iters)
                device_ms = graph_ms(torch, kernel_fn, iters)
                plain_ms = time_ms(torch, plain_fn, 5 if B == 4096 else 20)
                # lit, the plane and the rule columns read once, the
                # output written once; 2 ops per multiply-add
                b_ms, b_by = bound_ms(B * L + L * R + 3 * 4 * R + out_bytes, 2.0 * B * L * R)
                shapes[k].append({
                    "plane": plane_name, "B": B, "L": L, "R": R, "G": G,
                    "rule_tile": cuda_match.rule_tile(B, R, n_sm), "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "library_int_mm_ms": int_mm_ms,
                    "library_int_mm_rows": int_mm_rows,
                })
    # the rule-tile choice: each tile forced in turn (rule_tile replaced
    # for the probe only; these launches are not main-path launches)
    real_tile = cuda_match.rule_tile
    tiles = {}
    try:
        for plane_name, (lit_all, W, th, grp, pol, T, gate, _, maps) in planes.items():
            G = plain.n_groups_of(T, gate)
            for bn in (64, 128, 256):
                cuda_match.rule_tile = lambda B, R, n, bn=bn: bn  # noqa: E731
                tiles[f"{plane_name} B=4096 tile {bn}"] = graph_ms(
                    torch, lambda: cuda_match.match_groups(
                        lit_all, W, th, grp, pol, G, plane_maps=maps), 20)
    finally:
        cuda_match.rule_tile = real_tile
    print(f"rule-tile probe, match_groups_kernel device ms ({card}): "
          + json.dumps(tiles), flush=True)

    clock("8")
    # ---- 8. webhook: the CLI entry point on the card, over HTTP (4b's
    # interpreter check beside its servers' start-up)
    t_4b = time.monotonic()
    collect_4b = interpreter_answers_started(
        {"synth": ("synth", synth), "gated": ("gated", gated)}, args.policies, args.seed,
        piece=128)
    webhook_launches, big_expected = webhook_phase(
        args, card, corpus, g_batch, lambda: check_4b(collect_4b, t_4b), big)

    clock("9")
    # ---- 9. admission: /v1/admit, and beside /v1/authorize, then
    # ---- 10. live policy reload under traffic on both endpoints, then
    # ---- 11. resilience: chaos windows, all on one server (phase 9's
    # own server until phase 21 needed the time)
    # the later phases' pool: 4096 distinct gated bodies, as each
    # --only-* run draws it (phases 4b and 8 serve 2048 of them twice)
    pool = gated_bodies(corpus, 4096, seed=args.seed + 6)
    reload_launches, admission_launches, resilience_launches = reload_phase(
        args, card, pool, then=resilience_then(args, card), first=(big, big_expected))

    clock("12")
    # ---- 12. the CRD store: Policy object events, incremental reloads
    crd_launches = crd_phase(args, card, pool)

    clock("13")
    # ---- 13. the validationMode load gate: its cost, strict and partial
    gate_launches = gate_phase(args, card, corpus, pool)

    clock("14")
    # ---- 14. the decision cache ahead of the CRD-served engines
    cache_launches = cache_phase(args, card, pool)

    clock("15")
    # ---- 15. the request observability plane around both endpoints, then
    # ---- 17. the explain plane and 18. the shadow rollout on the same server
    obs_launches, (explain_out, rollout_launches) = obs_phase(
        args, card, pool, then=then_all(
            explain_then(args, card, engine=engine, split_bodies=bodies),
            rollout_then(args, card, corpus)))

    clock("16")
    # ---- 16. the overload-control plane under an open-loop flash crowd
    load_launches = load_phase(args, card, pool)

    clock("19")
    # ---- 19. the declarative lifecycle on its own server, with the
    # device-exact sweep on phase 4's engine while that server starts
    lifecycle_launches = lifecycle_phase(args, card, corpus, engine, tiers)

    clock("20")
    # ---- 20. ten tenants fused into one pair of card engines behind the
    # tenant front end, held to each tenant's own interpreter
    tenancy_launches = tenancy_phase(args, card, parity)

    clock("21")
    # ---- 21. the PDP front end: Envoy ext_authz and batch-authorize
    # traffic beside SARs on one server, held to the PdpOracle
    pdp_launches = pdp_phase(args, card)

    # each kernel's launches on every path this run drove, each counted
    # from 0 just before its path and read just after (a server's in its
    # process; phase 18's adds the shadow worker's launches on the
    # candidate engines); ``launches`` is their sum. Phase 17's explain
    # window launches neither kernel by design: launches_explain 0
    kernels = []
    for k, meta in kinds.items():
        head = shapes[k][0]  # the serving plane at B = 4096
        per_path = {
            "launches_pdp": pdp_launches[k],
            "launches_tenancy": tenancy_launches[k],
            "launches_lifecycle": lifecycle_launches[k],
            "launches_rollout": rollout_launches[k],
            "launches_explain": explain_out["launches"][k],
            "launches_load": load_launches[k],
            "launches_obs": obs_launches[k],
            "launches_cache": cache_launches[k],
            "launches_gate": gate_launches[k],
            "launches_crd": crd_launches[k],
            "launches_resilience": resilience_launches[k],
            "launches_reload": reload_launches[k],
            "launches_admission": admission_launches[k],
            "launches_webhook": webhook_launches[k],
            "launches_fastpath": {label: c[k] for label, c in fast_launches.items()},
            "launches_fastpath_gated": gated_launches[k],
            "launches_serving": serving_launches[k],
            "launches_want_full": full_launches[k],
        }
        total = sum(sum(v.values()) if isinstance(v, dict) else v for v in per_path.values())
        kernels.append({
            "name": k, **meta,
            "launches": total, **per_path,
            "max_abs_err": err[k],
            "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_int_mm_ms": head["library_int_mm_ms"],
            "shape": {d: head[d] for d in ("B", "L", "R", "G")},
            "shapes": shapes[k],
        })
    for k in kinds:
        for s in shapes[k]:
            print(f"time {k} {s['plane']} B={s['B']} L={s['L']} R={s['R']} "
                  f"(rule tile {s['rule_tile']}): {s['ms']:.4f} ms, device {s['device_ms']:.4f} "
                  f"ms (plain "
                  f"{s['plain_ms']:.4f}, bound {s['bound_ms']:.4f} by {s['bound_by']}, "
                  f"float32 matmul {s['library_ms']:.4f}, int8 _int_mm "
                  f"{s['library_int_mm_ms']} at {s['library_int_mm_rows']} rows)", flush=True)

    print(f"smoke wall time ({card}): {time.monotonic() - t_smoke:.1f} s", flush=True)
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)


def profile_stages(card: str, fast, bodies: list) -> None:
    """--profile: where a lone request's time goes, in this process (the
    webhook is stopped). The three pipeline stages called one body at a
    time on this thread (median ms each), fifty of those under
    torch.profiler (this thread's top host-side ops by self CPU time, and
    the device's busy time), then the same bodies submitted one at a
    time to an in-process PipelinedBatcher (p50 and mean stage ms from
    its histograms): the same work on the pipeline's threads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cedar_tpu_torch.engine.batcher import PipelinedBatcher
    from cedar_tpu_torch.server.metrics import WebhookMetrics

    def one(body, split):
        t0 = time.perf_counter()
        ctx = fast.pipeline_encode([body])
        t1 = time.perf_counter()
        ctx = fast.pipeline_dispatch(ctx)
        t2 = time.perf_counter()
        fast.pipeline_decode(ctx)
        t3 = time.perf_counter()
        for k, a, b in (("encode", t0, t1), ("dispatch", t1, t2), ("decode", t2, t3)):
            split[k].append(b - a)

    split = {"encode": [], "dispatch": [], "decode": []}
    for body in bodies:
        one(body, split)
    print(f"profile webhook stages, one thread, batch 1 ({card}): median ms "
          + json.dumps({k: round(pct(v, 50) * 1e3, 4) for k, v in split.items()}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for body in bodies[:50]:
            one(body, {"encode": [], "dispatch": [], "decode": []})
        wall = time.perf_counter() - t
    cpu, dev, n_dev = {}, 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev += ev.self_device_time_total
            n_dev += ev.count
        else:
            cpu[ev.key[:50]] = (ev.self_cpu_time_total, ev.count)
    top = sorted(cpu.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"profile webhook stages, 50 bodies one at a time on one thread ({card}): wall "
          f"{wall:.4f} s, device busy {dev / 1e6:.6f} s over {n_dev} device kernels and "
          "copies; top host ops by self CPU us (calls): "
          + json.dumps({k: [round(v[0], 1), v[1]] for k, v in top}), flush=True)
    m = WebhookMetrics()
    b = PipelinedBatcher(fast, depth=2, encode_workers=0, metrics=m, metrics_path="authorization")
    try:
        lat = []
        for body in bodies:
            t = time.perf_counter()
            b.submit(body, timeout=60)
            lat.append(time.perf_counter() - t)
    finally:
        b.stop()
    stages = {k: round(v[0] / max(v[1], 1) * 1e3, 4) for k, v in stage_totals(m.expose()).items()}
    print(f"profile webhook stages, in-process PipelinedBatcher, concurrency 1 ({card}): "
          f"p50 {pct(lat, 50) * 1e3:.3f} ms; mean stage ms {json.dumps(stages)}", flush=True)


def stage_totals(metrics_text: str, path=None) -> dict:
    """{stage: (sum s, count)} of cedar_pipeline_stage_seconds (of one
    path's series when `path` is given)."""
    out: dict = {}
    for line in metrics_text.splitlines():
        if path is not None and f'path="{path}"' not in line:
            continue
        for part, k in (("_sum{", 0), ("_count{", 1)):
            if line.startswith("cedar_pipeline_stage_seconds" + part):
                stage = line.split('stage="')[1].split('"')[0]
                vals = out.setdefault(stage, [0.0, 0.0])
                vals[k] = float(line.rsplit(" ", 1)[1])
    return out


def drive(port: int, bodies: list, concurrency: int, path: str = "/v1/authorize"):
    """POST every body from `concurrency` client threads, one keep-alive
    connection each -> (wall s, [latency s], [answer], [client error])."""
    lat = [0.0] * len(bodies)
    got = [None] * len(bodies)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        c = Client(port, path)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= len(bodies):
                    return
                got[i], lat[i] = c.post(bodies[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish within 600 s")
    return wall, lat, got, errors


def count_flips(label: str, got: list, expected: list, lat: list) -> int:
    """Answers unlike the expected ones; prints the first three."""
    flips = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
    for i in flips[:3]:
        print(f"webhook {label}: body {i} took {lat[i] * 1e3:.3f} ms, "
              f"expected {json.dumps(expected[i])}, got {json.dumps(got[i])}", flush=True)
    return len(flips)


def run_window(port: int, bodies: list, expected: list, concurrency: int,
               path: str = "/v1/authorize"):
    """drive(), failing on any client error -> (wall s, [latency s], flips
    vs expected)."""
    wall, lat, got, errors = drive(port, bodies, concurrency, path)
    if errors:
        fail(f"webhook {path} concurrency {concurrency}: client errors {errors[:3]}")
    return wall, lat, count_flips(f"{path} concurrency {concurrency}", got, expected, lat)


class Webhook:
    """One `python3 -m cedar_tpu_torch.cli.webhook --insecure` subprocess
    on free ports, its output in a log file under `tmp`."""

    def __init__(self, cfg: str, tmp: str, name: str, grace: float, flags=(),
                 cache: bool = False):
        self.port, self.mport = free_port(), free_port()
        self.grace = grace
        self.log_path = os.path.join(tmp, f"{name}.log")
        # without the decision cache unless asked (phase 14): the other
        # phases measure the device path and the breaker's posture, which
        # cached answers would bypass
        off = () if cache else ("--decision-cache-size", "0")
        self.cmd = [sys.executable, "-m", "cedar_tpu_torch.cli.webhook", "--config", cfg,
                    "--insecure", "--bind-address", "127.0.0.1", "--secure-port",
                    str(self.port), "--metrics-port", str(self.mport),
                    "--shutdown-grace-seconds", str(grace), *off, *flags]
        self.t0 = time.monotonic()
        with open(self.log_path, "w") as log_f:
            self.proc = subprocess.Popen(self.cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                         cwd=os.path.dirname(os.path.abspath(__file__)))

    def log(self) -> str:
        with open(self.log_path) as f:
            lines = f.read().splitlines()
        return "\n".join(line for line in lines if "requestId=" not in line)[-4000:]

    def wait_ready(self, card: str) -> None:
        """Freeze this process's heap while the server starts (no client
        runs yet), then poll /readyz; a server that exits or is not ready
        in 600 s fails."""
        took, n = freeze_client_heap()
        print(f"client heap: a full collection took {took * 1e3:.3f} ms, then {n} "
              f"objects frozen ({gc.get_freeze_count()} in all)", flush=True)
        deadline = time.monotonic() + 600
        while True:
            if self.proc.poll() is not None:
                fail(f"the webhook exited with code {self.proc.returncode} before it was "
                     f"ready:\n{self.log()}")
            try:
                if http_get(self.mport, "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail(f"the webhook was not ready within 600 s:\n{self.log()}")
            time.sleep(0.2)
        print(f"webhook: ready in {time.monotonic() - self.t0:.1f} s ({card}): "
              f"{' '.join(self.cmd[1:])}", flush=True)

    def debug_engine(self) -> dict:
        return json.loads(http_get(self.mport, "/debug/engine")[1])

    def terminate(self):
        """SIGTERM; reaped with wait4 -> (seconds to exit, peak RSS text).
        It must exit with code 0 within the grace window + 5 s."""
        t = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        while True:
            pid, status, usage = os.wait4(self.proc.pid, os.WNOHANG)
            if pid:
                self.proc.returncode = os.waitstatus_to_exitcode(status)
                break
            if time.monotonic() - t > self.grace + 5:
                fail(f"the webhook did not exit within {self.grace + 5:g} s of SIGTERM")
            time.sleep(0.05)
        took = time.monotonic() - t
        if self.proc.returncode != 0:
            fail(f"the webhook exited with code {self.proc.returncode} on SIGTERM:\n{self.log()}")
        return took, (f"{usage.ru_maxrss / 1024:.1f} MiB" if usage.ru_maxrss else "not measured")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def webhook_phase(args, card: str, corpus, bodies: list, oracle, clean: list) -> dict:
    """Phase 8 (module docstring): `bodies` are the gated sub-phase's,
    with the interpreter's answers from `oracle()` (called once the
    servers are starting); `clean` more synth bodies
    (no gated scope forced). Returns the server's kernel launch counts
    over the phase's traffic."""
    from cedar_tpu_torch.corpus.synth import synth_source
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import SARFastPath
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.server.sar import sar_response
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
    from cedar_tpu_torch.stores.store import TieredPolicyStores

    grace = 5.0
    with tempfile.TemporaryDirectory(prefix="cedar-webhook-") as tmp:
        pol_dir = os.path.join(tmp, "policies")
        os.mkdir(pol_dir)
        # the gated set: the corpus in one file, the two gated policies in
        # another; a directory store names policy i of a file
        # <file>.policy<i>, the interpreter's set its own ids
        with open(os.path.join(pol_dir, "synth.cedar"), "w") as f:
            f.write(synth_source(args.policies, seed=args.seed))
        with open(os.path.join(pol_dir, "gated.cedar"), "w") as f:
            f.write(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY)
        rename = {f"synth.cedar.policy{i}": p.policy_id for i, p in enumerate(corpus.policies)}
        extra = PolicySet.from_source(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY, "gated").policies()
        rename.update({f"gated.cedar.policy{j}": p.policy_id for j, p in enumerate(extra)})
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "directory",
                                            "directoryStore": {"path": pol_dir}}]}}, f)
        srv = Webhook(cfg, tmp, "webhook", grace)
        port, mport = srv.port, srv.mport
        # the two other serving modes of the CLI, on the card: the serial
        # batch loop (--pipeline-depth 0), and --no-native (no fast path:
        # each request thread evaluates its own SAR on the engine). They
        # start with the main server (a start is one process's compile,
        # about 20 s) and idle until its windows are done; then each
        # serves the first 300 gated bodies from 16 clients, 0 flips,
        # while the other one idles
        alts = [(flags, Webhook(cfg, tmp, "webhook" + "".join(flags), grace, flags))
                for flags in (("--pipeline-depth", "0"), ("--no-native",))]
        try:
            # the expected answers meanwhile, in this process: the library
            # fast path over a store built from the same directory
            stores = TieredPolicyStores([DirectoryPolicyStore(pol_dir, start_ticker=False)])
            x_engine = TorchPolicyEngine()
            x_engine.load([s.policy_set() for s in stores])
            x_fast = SARFastPath(x_engine, CedarWebhookAuthorizer(
                stores, evaluate_batch=x_engine.evaluate_batch))
            expected = [sar_response(*r)["status"] for r in x_fast.authorize_raw(bodies)]
            expected_clean = [sar_response(*r)["status"] for r in x_fast.authorize_raw(clean)]
            oracle = oracle()
            lib_flips = sum(reason_key(e, rename) != reason_key(o, {})
                            for e, o in zip(expected, oracle))
            print(f"webhook expected answers: library fast path over the directory store, "
                  f"flips vs the interpreter {lib_flips}", flush=True)
            if lib_flips or len(expected) != len(oracle):
                fail(f"webhook phase: {lib_flips} expected answers differ from the interpreter")

            srv.wait_ready(card)

            def snapshot():
                doc = srv.debug_engine()["authorization"]
                return doc, http_get(mport, "/metrics")[1].decode()

            doc, text = snapshot()
            if any(doc["engine"]["launches"].values()) or doc["engine"]["device"] != "cuda":
                fail(f"webhook before traffic: {doc['engine']}")
            print(f"webhook start-up warm-up launches: "
                  f"{json.dumps(doc['engine']['warmup_launches'])}", flush=True)
            flips = 0
            n64 = 2048
            for label, win_bodies, win_expected, conc in (
                ("concurrency 1", bodies[:300], expected[:300], 1),
                ("concurrency 64", bodies[:n64], expected[:n64], 64),
                ("concurrency 64, no gated body", clean[:n64], expected_clean[:n64], 64),
            ):
                wall, lat, n_flips = run_window(port, win_bodies, win_expected, conc)
                flips += n_flips
                doc2, text2 = snapshot()
                p1, p2 = doc["pipeline"], doc2["pipeline"]
                n_batches = p2["batches_total"] - p1["batches_total"]
                mean = (p2["rows_total"] - p1["rows_total"]) / max(n_batches, 1)
                st1, st2 = stage_totals(text), stage_totals(text2)
                stages = {k: round((st2[k][0] - st1.get(k, [0, 0])[0])
                                   / max(st2[k][1] - st1.get(k, [0, 0])[1], 1) * 1e3, 4)
                          for k in sorted(st2)}
                l1, l2 = doc["engine"]["launches"], doc2["engine"]["launches"]
                print(f"webhook {label} ({card}): {len(win_bodies) / wall:.1f} requests/s, "
                      f"p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms, "
                      f"first body {lat[0] * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms, "
                      f"mean batch {mean:.2f} over {n_batches} batches, flips vs expected "
                      f"{n_flips} / {len(win_bodies)}; mean stage ms per batch "
                      f"{json.dumps(stages)}; launches "
                      f"{json.dumps({k: l2[k] - l1[k] for k in l2})}", flush=True)
                if label == "concurrency 64" and not mean > 1:
                    fail(f"webhook: mean batch {mean:.2f} under 64 clients, want above 1")
                doc, text = doc2, text2
            launches = doc["engine"]["launches"]
            fallback = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith("cedar_authorizer_fallback_batches_total{"))
            routing = {line.split('row_class="')[1].split('"')[0]: int(float(line.rsplit(" ", 1)[1]))
                       for line in text.splitlines()
                       if line.startswith("cedar_authorizer_row_routing_total{")}
            pipe = doc["pipeline"]
            print(f"webhook launches {json.dumps(launches)}, fallback batches {fallback:g}, "
                  f"routing {json.dumps(routing)}", flush=True)
            print("webhook pipeline: " + json.dumps({k: pipe[k] for k in (
                "batches_total", "rows_total", "largest_batch", "inflight_peak",
                "stall_seconds", "depth", "encode_workers")}), flush=True)
            print(f"webhook largest batch ({card}): {pipe['largest_batch']}", flush=True)
            if flips:
                fail(f"webhook: {flips} answers differ from the expected ones")
            if launches["match_words_kernel"] < 1 or launches["match_groups_kernel"] < 1:
                fail(f"webhook traffic should launch both kernels: {launches}")
            if fallback:
                fail(f"webhook: {fallback:g} fallback batches")
            quiet = resilience_quiet("webhook", text)
            if quiet:
                fail("; ".join(quiet))

            took, rss = srv.terminate()
            print(f"webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        except BaseException:
            for _, alt in alts:
                alt.kill()
            raise
        finally:
            srv.kill()

        try:
            for _, alt in alts:
                alt.wait_ready(card)
            for flags, alt in alts:
                wall, lat, n_flips = run_window(alt.port, bodies[:300], expected[:300], 16)
                doc = alt.debug_engine()
                mode = (f"{doc['authorization']['pipeline']['mode']} batcher, launches "
                        f"{json.dumps(doc['authorization']['engine']['launches'])}"
                        if doc else "no batcher")
                print(f"webhook {' '.join(flags)}, concurrency 16 ({card}): "
                      f"{300 / wall:.1f} requests/s, p50 {pct(lat, 50) * 1e3:.3f} ms, "
                      f"p99 {pct(lat, 99) * 1e3:.3f} ms, first body {lat[0] * 1e3:.3f} ms, "
                      f"max {max(lat) * 1e3:.3f} ms, {mode}, flips vs expected "
                      f"{n_flips} / 300", flush=True)
                if n_flips:
                    fail(f"webhook {' '.join(flags)}: {n_flips} answers differ from the "
                         "expected ones")
                if doc and not all(doc["authorization"]["engine"]["launches"].values()):
                    fail(f"webhook {' '.join(flags)} should launch both kernels: {mode}")
                alt.terminate()
        finally:
            for _, alt in alts:
                alt.kill()
        if args.profile:
            profile_stages(card, x_fast, bodies[:200])
        return launches, expected_clean


def metric_total(text: str, family: str) -> float:
    """The sum of every series of one family on /metrics."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(family + "{") or line.startswith(family + " "))


def metric_above(text: str, family: str, le: str) -> float:
    """The observations of one histogram family above its `le` bucket,
    summed over its series."""
    below = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith(family + "_bucket{") and f'le="{le}"' in line)
    return metric_total(text, family + "_count") - below


RESILIENCE_FAMILIES = ("cedar_authorizer_breaker_transitions_total",
                       "cedar_supervisor_restarts_total", "cedar_device_rebuilds_total")


def resilience_quiet(label: str, text: str) -> list:
    """Phases 8-10 serve with the breaker and the supervisor at the CLI
    defaults: no breaker transition, no supervisor restart and no device
    rebuild may show on /metrics. Prints the three; returns the problems."""
    got = {f: metric_total(text, f) for f in RESILIENCE_FAMILIES}
    print(f"{label} resilience: " + ", ".join(f"{f} {v:g}" for f, v in got.items()), flush=True)
    return [f"{label}: {f} is {v:g}, want 0" for f, v in got.items() if v]


def metric_values(text: str, family: str, label: str, path: str) -> dict:
    """{label value: value} of one family's series with path="<path>"."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") and f'path="{path}"' in line:
            out[line.split(f'{label}="')[1].split('"')[0]] = float(line.rsplit(" ", 1)[1])
    return out


# phase 9's review pool: ADMISSION_DISTINCT bodies, each served
# ADMISSION_REPEAT times (4096 distinct until phase 21 needed the time,
# 1024 until the offline toolchain's slice did: the interpreter answers
# each body once)
ADMISSION_DISTINCT, ADMISSION_REPEAT = 256, 4


def admission_prep(args, pol_dir: str) -> dict:
    """Phase 9's reviews and their expected answers: the library
    AdmissionFastPath over the directory `pol_dir` (phase 10's version 0,
    phase 9's files) plus the allow-all tier, in this process while the
    server starts; the distinct bodies go to the oracle pool."""
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import AdmissionFastPath
    from cedar_tpu_torch.server.admission import (
        CedarAdmissionHandler,
        allow_all_admission_policy_store,
    )
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
    from cedar_tpu_torch.stores.store import TieredPolicyStores

    distinct = admission_bodies(ADMISSION_DISTINCT, args.seed + 9)
    bodies = distinct * ADMISSION_REPEAT
    stores = TieredPolicyStores([DirectoryPolicyStore(pol_dir, start_ticker=False),
                                 allow_all_admission_policy_store()])
    x_engine = TorchPolicyEngine()
    x_engine.load([s.policy_set() for s in stores])
    x_fast = AdmissionFastPath(x_engine, CedarAdmissionHandler(
        stores, evaluate_batch=x_engine.evaluate_batch))
    t0 = time.monotonic()
    expected = [r.to_admission_review()["response"] for r in x_fast.handle_raw(bodies)]
    print(f"admission expected answers: library fast path in "
          f"{time.monotonic() - t0:.2f} s, routing {json.dumps(x_fast.routing)}", flush=True)
    return {"bodies": bodies, "distinct": distinct, "expected": expected}


def admission_phase(args, card: str, srv, prep: dict, oracle: list, sars: list,
                    sar_expected: list) -> dict:
    """Phase 9 (module docstring) on phase 10's server at version 0, before
    phase 10's traffic: `prep` is admission_prep's, `oracle` the
    interpreter's answers of its distinct bodies; `sars` and
    `sar_expected` are phase 8's SAR bodies and expected answers, for the
    mixed window. Returns the server's kernel launch counts over the
    admission-only windows."""
    t_phase = time.monotonic()
    port, mport = srv.port, srv.mport
    bodies, expected = prep["bodies"], prep["expected"]
    by_body = {b: d["response"] for b, d in zip(prep["distinct"], oracle)}
    lib_flips = sum(adm_key(e) != adm_key(by_body[b]) for b, e in zip(bodies, expected))
    print(f"admission interpreter check: {len(bodies)} answers of {len(by_body)} distinct "
          f"bodies, flips vs the library fast path {lib_flips}", flush=True)
    if lib_flips or len(expected) != len(bodies):
        fail(f"admission phase: {lib_flips} expected answers differ from the interpreter")

    def snapshot():
        return srv.debug_engine(), http_get(mport, "/metrics")[1].decode()

    doc0, text0 = snapshot()
    if "admission" not in doc0:
        fail(f"/debug/engine has no admission entry: {sorted(doc0)}")
    for path in ("authorization", "admission"):
        eng = doc0[path]["engine"]
        print(f"admission phase {path} engine plane ({card}): L={eng['L']} R={eng['R']} "
              f"rules={eng['rules']} fallback={eng['fallback_policies']} "
              f"warm-up launches {json.dumps(eng['warmup_launches'])}", flush=True)
    if any(doc0["admission"]["engine"]["launches"].values()):
        fail(f"admission engine before traffic: {doc0['admission']['engine']}")
    flips = 0
    doc, text = doc0, text0
    for label, n, conc in (("concurrency 1", 300, 1), ("concurrency 64", len(bodies), 64)):
        wall, lat, n_flips = run_window(port, bodies[:n], expected[:n], conc, "/v1/admit")
        flips += n_flips
        doc2, text2 = snapshot()
        p1, p2 = doc["admission"]["pipeline"], doc2["admission"]["pipeline"]
        n_batches = p2["batches_total"] - p1["batches_total"]
        mean = (p2["rows_total"] - p1["rows_total"]) / max(n_batches, 1)
        l1, l2 = doc["admission"]["engine"]["launches"], doc2["admission"]["engine"]["launches"]
        print(f"admission {label} ({card}): {n / wall:.1f} requests/s, "
              f"p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms, "
              f"max {max(lat) * 1e3:.3f} ms, mean batch {mean:.2f} over {n_batches} "
              f"batches, flips vs expected {n_flips} / {n}; launches "
              f"{json.dumps({k: l2[k] - l1[k] for k in l2})}", flush=True)
        if label == "concurrency 64" and not mean > 1:
            fail(f"admission: mean batch {mean:.2f} under 64 clients, want above 1")
        doc, text = doc2, text2
    l0, l1 = doc0["admission"]["engine"]["launches"], doc["admission"]["engine"]["launches"]
    launches = {k: l1[k] - l0[k] for k in l1}
    r0, r1 = (metric_values(t, "cedar_authorizer_row_routing_total", "row_class",
                            "admission") for t in (text0, text))
    routing = {k: int(r1.get(k, 0) - r0.get(k, 0)) for k in
               ("clean_native", "gated", "flagged", "encoder_fallback", "encoder_gate")}
    fallback = sum(v for line in text.splitlines()
                   if line.startswith("cedar_authorizer_fallback_batches_total{")
                   for v in [float(line.rsplit(" ", 1)[1])])
    pipe = doc["admission"]["pipeline"]
    print(f"admission windows: launches {json.dumps(launches)}, routing "
          f"{json.dumps(routing)}, fallback batches {fallback:g}", flush=True)
    print(f"admission batches ({card}): mean "
          f"{pipe['rows_total'] / max(pipe['batches_total'], 1):.2f}, largest "
          f"{pipe['largest_batch']}", flush=True)
    if launches["match_words_kernel"] < 1 or launches["match_groups_kernel"] < 1:
        fail(f"admission traffic should launch both kernels: {launches}")
    missing = [k for k in ("gated", "flagged", "encoder_fallback", "encoder_gate")
               if routing[k] < 1]
    if missing:
        fail(f"admission traffic took no row down {missing}: {routing}")
    if fallback:
        fail(f"admission: {fallback:g} fallback batches")
    quiet = resilience_quiet("admission", text)
    if quiet:
        fail("; ".join(quiet))

    # the mixed window: both endpoints at once, from 32 clients each
    n_mix = 512
    out = {}

    def one(key, path, win):
        out[key] = drive(port, win, 32, path)

    threads = [threading.Thread(target=one, args=("admit", "/v1/admit", bodies[:n_mix])),
               threading.Thread(target=one, args=("authorize", "/v1/authorize",
                                                  sars[:n_mix]))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    mixed_wall = time.perf_counter() - t
    for key, want in (("admit", expected), ("authorize", sar_expected)):
        wall, lat, got, errors = out[key]
        if errors:
            fail(f"mixed window /v1/{key}: client errors {errors[:3]}")
        n_flips = count_flips(f"mixed /v1/{key}", got, want[:n_mix], lat)
        flips += n_flips
        print(f"admission mixed window /v1/{key}, 32 clients ({card}): "
              f"{n_mix / wall:.1f} requests/s, p50 {pct(lat, 50) * 1e3:.3f} ms, "
              f"p99 {pct(lat, 99) * 1e3:.3f} ms, flips vs expected {n_flips} / "
              f"{n_mix}", flush=True)
    print(f"admission mixed window ({card}): {2 * n_mix} requests in {mixed_wall:.3f} s "
          f"({2 * n_mix / mixed_wall:.1f} requests/s)", flush=True)
    print(f"admission flips over the three windows: {flips}", flush=True)
    if flips:
        fail(f"admission: {flips} answers differ from the expected ones")

    print(f"admission phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


# phase 10's edits: a forbid file that flips every watch SAR and every
# admission delete, then admission.cedar without its first forbid
RELOAD_FLIP_POLICY = """
forbid (principal, action == k8s::Action::"watch", resource is k8s::Resource);
forbid (principal, action == k8s::admission::Action::"delete", resource);
"""
ADM_POLICIES_EDITED = "forbid (" + ADM_POLICIES.split("forbid (", 2)[2]


def gpu_memory_mib(pid: int):
    """The card memory of process `pid` in MiB (nvidia-smi
    --query-compute-apps), or None when nvidia-smi does not list it (in a
    container it may see no process of its own)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0] == str(pid):
            return float(parts[1].split()[0])
    return None


# phase 10's full-compile seconds by phase, per reload and engine: phase 12
# prints its incremental ones beside them
PHASE10_COMPILE: list = []


def reload_phase(args, card: str, sars: list, then=None, first=None):
    """Phase 10 (module docstring): `sars` are the gated SAR pool. With
    ``first`` (phase 8's SARs and their expected answers), phase 9 runs
    first on this server, at version 0 (phase 9's files), before phase
    10's traffic. Returns the server's kernel launch counts over phase 10's
    traffic (served counts, warm-ups apart), phase 9's (None without
    ``first``) and what ``then`` returned: phase 11, run on this server
    once phase 10's checks have passed."""
    from cedar_tpu_torch.corpus.synth import synth_source

    t_phase = time.monotonic()
    grace = 5.0
    # distinct bodies a path (512 until the offline toolchain's slice
    # needed the time: the interpreter answers each once a version)
    n_pool = 256
    sars = sars[:n_pool]
    adms = admission_bodies(n_pool, args.seed + 10)
    with tempfile.TemporaryDirectory(prefix="cedar-reload-") as tmp:
        base = {
            "synth.cedar": synth_source(args.policies, seed=args.seed),
            "gated.cedar": FALLBACK_POLICY + NATIVE_OPAQUE_POLICY,
            "admission.cedar": ADM_POLICIES,
            "admission-demo.cedar": ADM_DEMO_OWNER_POLICY,
            "admission-gated.cedar": ADM_FALLBACK_POLICY,
        }
        # versions 0..2: the base, + the flip file, + admission.cedar
        # edited (a third reload, back to the base, was cut to keep the
        # whole smoke inside its time limit once phase 18 came)
        versions = [base, {**base, "flip.cedar": RELOAD_FLIP_POLICY},
                    {**base, "flip.cedar": RELOAD_FLIP_POLICY,
                     "admission.cedar": ADM_POLICIES_EDITED}]
        vdirs = []
        for k, files in enumerate(versions):
            vdir = os.path.join(tmp, f"v{k}")
            os.mkdir(vdir)
            for fname, text in files.items():
                with open(os.path.join(vdir, fname), "w") as f:
                    f.write(text)
            vdirs.append(vdir)
        pol_dir = os.path.join(tmp, "policies")
        os.symlink(vdirs[0], pol_dir)

        def swap_to(k):
            """Re-point the store's directory at version k atomically."""
            link = os.path.join(tmp, "policies.new")
            os.symlink(vdirs[k], link)
            os.replace(link, pol_dir)

        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "directory", "directoryStore": {
                           "path": pol_dir, "refreshInterval": "30s"}}]}}, f)
        # a 10 s request budget, the Kubernetes default for an admission
        # webhook: the phase holds the swap contract, and the serving cost
        # of a reload (the compile shares the interpreter lock with 64
        # closed-loop clients) is reported as latency, with no target;
        # full recompiles (--no-incremental-compile), the yardstick phase
        # 12's incremental reloads are printed beside
        # the breaker trips and the supervisor's wedge budget at the CLI
        # defaults; phase 11's chaos control, a 2 s recovery and a 0.5 s
        # watchdog interval (neither changes whether anything trips or
        # restarts, only how fast it recovers)
        srv = Webhook(cfg, tmp, "webhook-reload", grace,
                      ("--reload-seconds", "1", "--request-timeout-ms", "10000",
                       "--no-incremental-compile",
                       "--confirm-non-prod-inject-errors", "--breaker-recovery-seconds", "2",
                       "--supervisor-interval-seconds", "0.5"))
        port, mport = srv.port, srv.mport
        stop = threading.Event()
        threads = []
        try:
            # the expected answers meanwhile: phase 9's from the library
            # fast path, and the interpreter over each version's directory
            adm9 = admission_prep(args, vdirs[0]) if first is not None else None
            t0 = time.monotonic()
            tasks = {}
            for k in range(3):
                tasks[(k, "/v1/authorize")] = (f"dir-authorize:{vdirs[k]}", sars)
                tasks[(k, "/v1/admit")] = (f"dir-admit:{vdirs[k]}", adms)
            if adm9 is not None:
                tasks[(9, "/v1/admit")] = (f"dir-admit:{vdirs[0]}", adm9["distinct"])
            # pieces of n_pool: a worker builds one oracle per piece
            answers = interpreter_answers(tasks, args.policies, args.seed, piece=n_pool)
            keyf = {"/v1/authorize": lambda a: reason_key(a, {}),
                    "/v1/admit": adm_key}
            # the oracle's admission answers are whole AdmissionReviews
            oracle_of = {"/v1/authorize": lambda a: a, "/v1/admit": lambda a: a["response"]}
            want = {path: [[keyf[path](oracle_of[path](a)) for a in answers[(k, path)]]
                           for k in range(3)]
                    for path in ("/v1/authorize", "/v1/admit")}
            print(f"reload oracle: {sum(len(b) for _n, b in tasks.values())} interpreter "
                  f"answers over 3 versions (phase 9's included) in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            for path in want:
                for k in (1, 2):
                    n = sum(a != b for a, b in zip(want[path][k], want[path][k - 1]))
                    print(f"reload version {k} changes {n} of {n_pool} {path} answers", flush=True)
            srv.wait_ready(card)

            def engines():
                doc = srv.debug_engine()
                return {path: doc[path]["engine"] for path in ("authorization", "admission")}

            eng0 = engines()
            if any(eng0["authorization"]["launches"].values()):
                fail(f"reload: served launches before traffic: {eng0['authorization']['launches']}")
            before = None
            if first is not None:
                before = admission_phase(args, card, srv, adm9, answers[(9, "/v1/admit")],
                                         *first)
                del adm9
            # phase 10's launches count from here
            base = engines()["authorization"]["launches"]

            # traffic: 32 + 32 clients, without pause, until stopped
            records = {"/v1/authorize": [], "/v1/admit": []}
            pools = {"/v1/authorize": sars, "/v1/admit": adms}
            errors = []
            lock = threading.Lock()
            counters = {"/v1/authorize": 0, "/v1/admit": 0}

            def client(path):
                c = Client(port, path)
                try:
                    while not stop.is_set():
                        with lock:
                            i = counters[path] % n_pool
                            counters[path] += 1
                        sent = time.time()
                        got, dt = c.post(pools[path][i])
                        records[path].append((sent, time.time(), i, got, dt))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"{path}: {e!r}")
                finally:
                    c.close()

            for path in records:
                for _ in range(32):
                    threads.append(threading.Thread(target=client, args=(path,)))
            for th in threads:
                th.start()
            time.sleep(6.0)
            writes, publishes, mem, launch_marks = [], [], {}, []
            for k in (1, 2):
                gens = {p: e["load_generation"] for p, e in engines().items()}
                t_write = time.time()
                swap_to(k)
                deadline = time.monotonic() + 150
                while True:
                    eng = engines()
                    if all(eng[p]["load_generation"] > gens[p] for p in gens):
                        break
                    if errors or time.monotonic() > deadline:
                        fail(f"reload {k}: the engines did not step within 150 s "
                             f"(generations {gens}, client errors {errors[:3]}):\n{srv.log()}")
                    time.sleep(0.2)
                if any(eng[p]["load_generation"] != gens[p] + 1 for p in gens):
                    fail(f"reload {k}: a generation stepped twice: {gens} -> "
                         f"{ {p: eng[p]['load_generation'] for p in eng} }")
                writes.append(t_write)
                publishes.append({p: eng[p]["last_load"] for p in eng})
                launch_marks.append(eng["authorization"]["launches"])
                for p in ("authorization", "admission"):
                    last = eng[p]["last_load"]
                    PHASE10_COMPILE.append((k, p, last["compile_seconds"]))
                    print(f"reload {k} {p} engine ({card}): write to swap "
                          f"{last['published_unix'] - t_write:.3f} s, compile seconds "
                          f"{json.dumps(last['compile_seconds'])}", flush=True)
                time.sleep(4.0)
                if k in (1, 2):
                    # read once the batches in flight at the swap, which
                    # hold the retired plane until they answer, are done
                    dm = engines()["authorization"]["device_memory"]
                    mem[k] = {"nvidia-smi": gpu_memory_mib(srv.proc.pid),
                              "allocated": dm["allocated"] / 2**20,
                              "reserved": dm["reserved"] / 2**20}
            launch_marks.append(engines()["authorization"]["launches"])
            stop.set()
            for th in threads:
                th.join(timeout=120)
            if any(th.is_alive() for th in threads):
                fail("reload: a client thread did not finish within 120 s")
            if errors:
                fail(f"reload: client errors {errors[:3]}")

            # every answer is that of a version live while it was in flight
            engine_of = {"/v1/authorize": "authorization", "/v1/admit": "admission"}
            problems = []  # every check's failure, reported together at the end
            flips = 0
            for path, recs in records.items():
                pubs = [pb[engine_of[path]]["published_unix"] for pb in publishes]
                bounds = [float("-inf")] + pubs + [float("inf")]
                changed = [0, 0, 0]
                # answers no live version gives, by the version live at
                # their answer: deadline expiries apart from the rest
                odd = {}
                for sent, done, i, got, _dt in recs:
                    live = [v for v in range(3) if bounds[v] < done and bounds[v + 1] > sent]
                    key = keyf[path](got)
                    if not any(key == want[path][v][i] for v in live):
                        flips += 1
                        kind = "deadline" if "deadline of" in json.dumps(got) else "other"
                        at = odd.setdefault(f"version {live[-1]}", {})
                        at[kind] = at.get(kind, 0) + 1
                        if flips <= 3:
                            print(f"reload flip {path} body {i}: live versions {live}, got "
                                  f"{json.dumps(got)}", flush=True)
                    if len(live) == 1 and live[0] and key != want[path][live[0] - 1][i]:
                        changed[live[0]] += 1
                if odd:
                    print(f"reload {path}: answers of no live version {json.dumps(odd)}",
                          flush=True)
                print(f"reload {path}: {len(recs)} answers, answers unlike the previous "
                      f"version's after reloads 1-2: {changed[1:]}", flush=True)
                need = (1, 2) if path == "/v1/admit" else (1,)
                if any(changed[k] < 1 for k in need):
                    problems.append(f"{path}: a reload changed no answer: {changed[1:]}")
            print(f"reload flips: {flips}", flush=True)
            if flips:
                problems.append(f"{flips} answers are no version's live while in flight")

            # serving before each write and while each reload compiled,
            # and the first request sent after each swap
            for k, (t_write, pub) in enumerate(zip(writes, publishes), start=1):
                c0 = min(pub[p]["started_unix"] for p in pub)
                c1 = max(pub[p]["published_unix"] for p in pub)
                for path, recs in records.items():
                    row = []
                    for label, lo, hi in (("before", t_write - 5.0, t_write),
                                          ("compiling", c0, c1)):
                        lat = [dt for _s, done, _i, _g, dt in recs if lo <= done < hi]
                        row.append(f"{label} {len(lat) / max(hi - lo, 1e-9):.1f} requests/s "
                                   f"p99 {pct(lat, 99) * 1e3 if lat else float('nan'):.3f} ms "
                                   f"max {max(lat, default=float('nan')) * 1e3:.3f} ms")
                    p_swap = pub[engine_of[path]]["published_unix"]
                    first = min((r for r in recs if r[0] > p_swap), key=lambda r: r[0],
                                default=None)
                    fb = f"{first[4] * 1e3:.3f} ms" if first else "none"
                    print(f"reload {k} {path} ({card}): {'; '.join(row)} (compile window "
                          f"{c1 - c0:.3f} s); first request after the swap {fb}", flush=True)

            # both kernels launched on each new plane
            for k in (1, 2):
                a, b = launch_marks[k - 1], launch_marks[k]
                if not all(b[n] > a[n] for n in a):
                    problems.append(f"reload {k}: launches did not rise after the swap: "
                                    f"{a} -> {b}")
            launches = {k: launch_marks[-1][k] - base[k] for k in base}
            text = http_get(mport, "/metrics")[1].decode()
            fallback = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith("cedar_authorizer_fallback_batches_total{"))
            compiles = [line for line in text.splitlines()
                        if line.startswith("cedar_compile_seconds_count{")]
            print(f"reload launches {json.dumps(launches)}, fallback batches {fallback:g}, "
                  f"{'; '.join(compiles)}", flush=True)
            if fallback:
                problems.append(f"{fallback:g} fallback batches")
            problems += resilience_quiet("reload", text)
            plane = max(e["device_bytes"] for e in engines().values()) / 2**20
            print(f"reload card memory of the server, MiB ({card}; nvidia-smi's per-process "
                  f"figure where it lists the server, and the server's allocator): after reload "
                  f"1 {json.dumps(mem[1])}, after reload 2 {json.dumps(mem[2])}; one plane "
                  f"{plane:.1f} MiB", flush=True)
            for what in ("nvidia-smi", "allocated", "reserved"):
                if mem[1][what] is not None and mem[2][what] - mem[1][what] > plane:
                    problems.append(f"card memory ({what}) grew by "
                                    f"{mem[2][what] - mem[1][what]:.1f} MiB over reload 2, "
                                    f"more than one plane ({plane:.1f} MiB)")
            if problems:
                fail("reload: " + "; ".join(problems))
            print(f"reload phase wall time ({card}): {time.monotonic() - t_phase:.1f} s",
                  flush=True)
            after = None
            if then is not None:
                # the directory stays at version 2: its expected answers
                after = then(srv, pools, {path: want[path][2] for path in want}, keyf)
            took, rss = srv.terminate()
            print(f"reload webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            stop.set()
            srv.kill()
    return launches, before, after


class Traffic:
    """Closed-loop clients on both endpoints without pause: 32 per path,
    each on its own keep-alive connection, cycling over its pool. Records
    (sent unix, done unix, path, body index, answer, seconds) per answer;
    a client error is kept and fails the phase."""

    def __init__(self, port: int, pools: dict, per_path: int = 32):
        self.port, self.pools, self.per_path = port, pools, per_path
        self.records: list = []
        self.errors: list = []
        self._stop = threading.Event()
        self._next = {path: 0 for path in pools}
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._client, args=(path,))
                         for path in pools for _ in range(per_path)]

    def _client(self, path):
        c = Client(self.port, path)
        pool = self.pools[path]
        try:
            while not self._stop.is_set():
                with self._lock:
                    i = self._next[path] % len(pool)
                    self._next[path] += 1
                sent = time.time()
                got, dt = c.post(pool[i])
                self.records.append((sent, time.time(), path, i, got, dt))
        except Exception as e:  # noqa: BLE001 — reported by the phase
            self.errors.append(f"{path}: {e!r}")
        finally:
            c.close()

    def start(self):
        for th in self._threads:
            th.start()

    def stop(self):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=120)
        if any(th.is_alive() for th in self._threads):
            self.errors.append("a client thread did not finish within 120 s")


def posture_kind(path: str, got: dict):
    """The failure posture an answer carries: "breaker" (the open breaker
    answered before the batcher), "failed" (a failed or shed batch), or
    None for an evaluated answer."""
    if path == "/v1/authorize":
        err = got.get("evaluationError") or ""
        if got["allowed"] or got["denied"] or not err.startswith("evaluation error: "):
            return None
    else:
        err = got["status"]["message"]
        if got["status"]["code"] != 500 or not err.startswith("evaluation error ("):
            return None
    return "breaker" if err.endswith("device breaker open") else "failed"


def resilience_phase(args, card: str, srv, pools: dict, want: dict, keyf: dict) -> dict:
    """Phase 11 (module docstring) on phase 10's server, its directory
    at version 2: four chaos windows under 32 + 32 clients. Returns
    the server's served kernel launches over the phase."""
    t_phase = time.monotonic()
    port, mport = srv.port, srv.mport
    interval = 0.5  # --supervisor-interval-seconds of phase 10's server
    recovery = 2.0  # --breaker-recovery-seconds
    paths = {"/v1/authorize": "authorization", "/v1/admit": "admission"}
    problems = []

    def chaos(action, doc=None):
        data = json.dumps(doc).encode() if doc is not None else b""
        req = urllib.request.Request(f"http://127.0.0.1:{mport}/chaos/{action}", data=data,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            if r.status != 200:
                fail(f"resilience: /chaos/{action} answered {r.status}")
            return json.loads(r.read())

    def engine_doc():
        doc = srv.debug_engine()
        return {p: doc[p] for p in paths.values()}

    def supervisor_doc():
        return json.loads(http_get(mport, "/debug/supervisor")[1])

    def metrics_text():
        return http_get(mport, "/metrics")[1].decode()

    took, n = freeze_client_heap()  # phase 10's answers, before any client runs
    print(f"resilience client heap: a full collection took {took * 1e3:.3f} ms, then "
          f"{n} objects frozen", flush=True)
    traffic = Traffic(port, pools)
    launches0 = engine_doc()["authorization"]["engine"]["launches"]
    text0 = metrics_text()
    t_traffic = time.time()
    traffic.start()
    time.sleep(3.0)
    windows = []

    def server_slow() -> float:
        """Authorizations the server itself has timed over 0.7 s so far."""
        return metric_above(metrics_text(), "cedar_authorizer_request_duration_seconds", "0.7")

    def window(name):
        w = {"name": name, "t0": time.time(), "slow0": server_slow()}
        windows.append(w)
        return w

    # ---- (a) the breaker trips and recovers: non-fatal dispatch errors
    # until both breakers read open, then none
    w = window("breaker")
    chaos("configure", {"name": "breaker-trip", "seed": 31, "faults": [
        {"seam": "engine.dispatch", "kind": "error",
         "message": "injected dispatch fault (not fatal)"}]})
    chaos("arm")
    # (unix, {engine: state}, launches, {engine: batches_total}, drained):
    # drained when no request waits in either batcher and no batch is in
    # either pipeline (those in flight at a trip passed the breaker before
    # it opened)
    samples = []
    opened, closed = {}, {}
    deadline = time.monotonic() + 40
    while len(closed) < 2:
        doc = engine_doc()
        now = time.time()
        states = {e: doc[e]["breaker"] for e in doc}
        samples.append((now, states, doc["authorization"]["engine"]["launches"],
                        {e: doc[e]["pipeline"]["batches_total"] for e in doc},
                        all(doc[e]["pipeline"]["inflight"] == 0 and doc[e]["pipeline"]["queue"] == 0
                            for e in doc)))
        for e, st in states.items():
            if st == "open" and e not in opened:
                opened[e] = now
            if e in opened and st == "closed" and e not in closed:
                closed[e] = now
        if len(opened) == 2 and not w.get("disarmed"):
            chaos("disarm")
            w["disarmed"] = now
        if time.monotonic() > deadline or traffic.errors:
            fail(f"resilience (a): breakers opened {opened}, closed {closed} within 40 s "
                 f"(client errors {traffic.errors[:3]}):\n{srv.log()}")
        time.sleep(0.025)
    w["opened"], w["closed"] = opened, closed
    w["t_end"] = max(closed.values())
    # while open: no batch formed for that path, and with both open no
    # launch, once the batches in flight at the trip have drained (a
    # batch claimed before the trip fails at encode, without a launch)
    for e in paths.values():
        episode = [s for s in samples if s[1][e] == "open" and s[4]]
        if episode and episode[-1][3][e] != episode[0][3][e]:
            problems.append(f"(a) {e}: batches formed while its breaker was open "
                            f"({episode[0][3][e]} -> {episode[-1][3][e]})")
    both = [s for s in samples if all(v == "open" for v in s[1].values())]
    both = both[next((k for k, s in enumerate(both) if s[4]), len(both)):]
    if len(both) < 2:
        problems.append(f"(a) no window with both breakers open long enough to read: "
                        f"opened {opened}")
    elif both[-1][2] != both[0][2]:
        problems.append(f"(a) launches rose with both breakers open: {both[0][2]} -> "
                        f"{both[-1][2]}")
    w["both_open_s"] = both[-1][0] - both[0][0] if len(both) > 1 else 0.0
    w["launches_both_open"] = (both[0][2], both[-1][2]) if both else None
    time.sleep(3.0)

    # ---- (b) device loss: the builtin scenario; disarmed once both
    # engines' recoveries have seen a fatal error
    w = window("device-loss")
    doc = engine_doc()
    mem_before = doc["authorization"]["engine"]["device_memory"]["allocated"]
    plane = max(doc[e]["engine"]["device_bytes"] for e in doc)
    builtin = chaos_builtin("device-loss")
    chaos("configure", builtin)
    chaos("arm")
    deadline = time.monotonic() + 60
    seen, rebuilt = {}, {}
    while len(rebuilt) < 2:
        rec = supervisor_doc()["device_recovery"]
        now = time.time()
        for e, st in rec.items():
            if e not in seen and (st["rebuilding"] or st["rebuilds"] or st["failures"]):
                seen[e] = now
            if st["rebuilds"] and e not in rebuilt:
                rebuilt[e] = now
        if len(seen) == 2 and not w.get("disarmed"):
            chaos("disarm")
            w["disarmed"] = now
        if time.monotonic() > deadline or traffic.errors:
            fail(f"resilience (b): recoveries {rec} within 60 s (client errors "
                 f"{traffic.errors[:3]}):\n{srv.log()}")
        time.sleep(0.025)
    deadline = time.monotonic() + 30
    while True:
        doc = engine_doc()
        if all(doc[e]["breaker"] == "closed" for e in doc):
            break
        if time.monotonic() > deadline:
            fail(f"resilience (b): breakers did not close after the rebuild: "
                 f"{ {e: doc[e]['breaker'] for e in doc} }")
        time.sleep(0.025)
    w["t_end"] = time.time()
    rec = supervisor_doc()["device_recovery"]
    w["rebuild"] = {e: rec[e]["last_rebuild"] for e in rec}
    w["seen"], w["rebuilt"] = seen, rebuilt
    mark = doc["authorization"]["engine"]["launches"]
    time.sleep(3.0)
    doc = engine_doc()
    later = doc["authorization"]["engine"]["launches"]
    # once traffic has run on the rebuilt planes for 3 s
    mem_after = doc["authorization"]["engine"]["device_memory"]["allocated"]
    if not all(later[k] > mark[k] for k in mark):
        problems.append(f"(b) launches did not rise after the rebuild: {mark} -> {later}")
    for e, st in rec.items():
        if (st["rebuilds"], st["failures"]) != (1, 0):
            problems.append(f"(b) {e}: {st['rebuilds']} rebuilds, {st['failures']} failures, "
                            "want 1 and 0")
    rebuilds_total = metric_total(metrics_text(), "cedar_device_rebuilds_total")
    if rebuilds_total != 2:
        problems.append(f"(b) cedar_device_rebuilds_total {rebuilds_total:g}, want 1 per engine")
    if abs(mem_after - mem_before) > plane:
        problems.append(f"(b) card memory moved {(mem_after - mem_before) / 2**20:.1f} MiB "
                        f"over the rebuild, more than one plane ({plane / 2**20:.1f} MiB)")
    w["memory_mib"] = (mem_before / 2**20, mem_after / 2**20, plane / 2**20)
    w["launches_after"] = (mark, later)

    # ---- (c) a decode stage killed
    w = window("kill-decode")
    sup0 = supervisor_doc()["components"]
    chaos("configure", chaos_builtin("kill-decode"))
    t_arm = time.time()
    chaos("arm")
    deadline = time.monotonic() + 20
    while True:
        comps = supervisor_doc()["components"]
        restarted = [c for c in comps if comps[c]["restarts"] > sup0[c]["restarts"]]
        if restarted:
            break
        if time.monotonic() > deadline:
            fail(f"resilience (c): no stage revived within 20 s: {comps}\n{srv.log()}")
        time.sleep(0.02)
    w["t_revived"] = time.time()
    w["revived"] = {c: comps[c]["last_event"] for c in restarted}
    w["arm_to_revive_s"] = w["t_revived"] - t_arm
    chaos("disarm")
    if restarted[0] not in ("batcher.authorization", "batcher.admission") or len(restarted) != 1:
        problems.append(f"(c) restarted {restarted}, want one batcher")
    if w["arm_to_revive_s"] > 2 * interval + 0.1:
        problems.append(f"(c) the stage was revived {w['arm_to_revive_s']:.3f} s after the "
                        f"kill was armed, want within 2 x {interval} s")
    time.sleep(3.0)
    w["t_end"] = time.time()

    # ---- (d) the store stalls on re-read: serving goes on
    w = window("store-stall")
    chaos("configure", chaos_builtin("store-stall"))
    chaos("arm")
    deadline = time.monotonic() + 45
    while True:
        stats = json.loads(http_get(mport, "/debug/chaos")[1])
        calls = stats["seams"].get("store.load", {}).get("calls", 0)
        if calls:
            break
        if time.monotonic() > deadline:
            fail("resilience (d): the directory store did not re-read within 45 s")
        time.sleep(0.1)
    w["t_stall"] = time.time()
    time.sleep(3.0)  # the 2 s stall, and a second more
    chaos("reset")
    w["t_end"] = time.time()
    time.sleep(1.0)

    traffic.stop()
    t_stop, slow_end = time.time(), server_slow()
    if traffic.errors:
        fail(f"resilience: client errors {traffic.errors[:3]}")
    doc = engine_doc()
    launches1 = doc["authorization"]["engine"]["launches"]
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    # the staging of every failed, shed and stranded batch came back
    deadline = time.monotonic() + 10
    while True:
        staging = {e: engine_doc()[e]["engine"]["staging"] for e in paths.values()}
        if all(st["outstanding"] == 0 for st in staging.values()) or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for e, st in staging.items():
        if st["outstanding"]:
            problems.append(f"{e}: staging outstanding {st['outstanding']} at rest")
    text = metrics_text()

    # ---- the answers: a request in flight during a fault window may
    # answer the posture (the breaker window's only until its path's
    # breaker closed; the store-stall window's never); every other answer
    # must be the expected one
    recs = list(traffic.records)
    flips = 0
    for w in windows:
        w["counts"] = {"expected": 0, "breaker": 0, "failed": 0}
        w["breaker_lat"] = []
    for sent, done, path, i, got, dt in recs:
        w = next((w for w in windows if sent < w["t_end"] and done >= w["t0"]), None)
        if keyf[path](got) == want[path][i]:
            if w is not None:
                w["counts"]["expected"] += 1
            continue
        kind = posture_kind(path, got)
        allowed = w is not None and kind is not None and w["name"] != "store-stall"
        if allowed and w["name"] == "breaker" and sent >= w["closed"][paths[path]]:
            allowed = False
        if not allowed:
            flips += 1
            if w is not None and kind is not None:
                w["counts"][kind] += 1
            if flips <= 3:
                print(f"resilience flip ({w['name'] if w else 'no window'}) {path} body {i}: "
                      f"{json.dumps(got)}", flush=True)
            continue
        w["counts"][kind] += 1
        if kind == "breaker":
            w["breaker_lat"].append(dt)
    for w, nxt in zip(windows, windows[1:] + [None]):
        w["span_end"] = nxt["t0"] if nxt else t_stop
        w["slow"] = (nxt["slow0"] if nxt else slow_end) - w["slow0"]
        w["own"] = max((e[1] for e in CLIENT_GC.between(w["t0"], w["span_end"])),
                       default=0.0)
    for w in windows:
        lo, hi = w["t0"], w["t_end"]
        stats = []
        for label, a, b in (("before", lo - 3.0, lo), ("during", lo, hi), ("after", hi, hi + 3.0)):
            lat = [r[5] for r in recs if a <= r[1] < b]
            stats.append(f"{label} {len(lat) / max(b - a, 1e-9):.1f} requests/s p99 "
                         f"{pct(lat, 99) * 1e3 if lat else float('nan'):.3f} ms")
        counts, breaker_lat = w["counts"], w["breaker_lat"]
        extra = ""
        if w["name"] == "breaker":
            extra = (f"; open after {json.dumps({e: round(t - lo, 3) for e, t in w['opened'].items()})}"
                     f" s, closed after "
                     f"{json.dumps({e: round(t - lo, 3) for e, t in w['closed'].items()})} s, "
                     f"both open {w['both_open_s']:.3f} s with launches "
                     f"{json.dumps(w['launches_both_open'])}")
            # the open breaker answers without queueing behind a batch:
            # faster than the served answers before the fault. Its
            # absolute p99 under 64 closed-loop clients is the HTTP
            # layer's (the yardstick below), printed against 50 ms
            served = [r[5] for r in recs if lo - 3.0 <= r[1] < lo]
            if breaker_lat and served and pct(breaker_lat, 99) >= pct(served, 99):
                problems.append(f"(a) p99 of the open breaker's answers "
                                f"{pct(breaker_lat, 99) * 1e3:.3f} ms, not below the served "
                                f"answers' {pct(served, 99) * 1e3:.3f} ms before the fault "
                                f"(the clients' own longest collection pause "
                                f"{w['own'] * 1e3:.3f} ms, {w['slow']:g} authorizations "
                                f"the server timed over 0.7 s)")
            if not breaker_lat:
                problems.append("(a) no request was answered by an open breaker")
            extra += (f"; open-breaker answers p99 "
                      f"{'under' if breaker_lat and pct(breaker_lat, 99) < 0.05 else 'not under'}"
                      f" 50 ms")
        elif w["name"] == "device-loss":
            extra = (f"; fatal seen after "
                     f"{json.dumps({e: round(t - lo, 3) for e, t in w['seen'].items()})} s, "
                     f"rebuilt after "
                     f"{json.dumps({e: round(t - lo, 3) for e, t in w['rebuilt'].items()})} s, "
                     f"closed after {hi - lo:.3f} s; rebuild {json.dumps(w['rebuild'])}; "
                     f"allocator MiB before / after / one plane "
                     f"{json.dumps([round(x, 2) for x in w['memory_mib']])}; launches at close "
                     f"-> 3 s later {json.dumps(w['launches_after'])}")
        elif w["name"] == "kill-decode":
            extra = (f"; revived {w['arm_to_revive_s']:.3f} s after the arm: "
                     f"{json.dumps(w['revived'])}")
        elif w["name"] == "store-stall":
            extra = f"; the store's re-read stalled {w['t_stall'] - lo:.3f} s into the window"
        lat_b = (f", open-breaker answers p99 {pct(breaker_lat, 99) * 1e3:.3f} ms max "
                 f"{max(breaker_lat) * 1e3:.3f} ms" if breaker_lat else "")
        print(f"resilience ({w['name']}, {card}): {'; '.join(stats)}; answers "
              f"{json.dumps(counts)}{lat_b}{extra}; to the next window the clients' "
              f"longest own collection pause {w['own'] * 1e3:.3f} ms and "
              f"{w['slow']:g} authorizations the server timed over 0.7 s", flush=True)
        if w["name"] == "store-stall" and (counts["breaker"] or counts["failed"]):
            problems.append(f"(d) {counts['breaker'] + counts['failed']} posture answers")
        if w["name"] in ("breaker", "device-loss") and not (counts["breaker"] or counts["failed"]):
            problems.append(f"({w['name']}) no posture answer: the fault did not bite")
    print(f"resilience flips: {flips}", flush=True)
    own = CLIENT_GC.between(t_traffic, t_stop)
    print(f"resilience pauses ({card}): the clients' own collections under traffic "
          f"(every full one, any other of 5 ms or more) {len(own)} "
          f"({sum(e[2] == 2 for e in own)} full), the longest "
          f"{max((e[1] for e in own), default=0.0) * 1e3:.3f} ms", flush=True)
    yard = http_yardstick(pools)
    print(f"resilience yardstick ({card}): the same 32 + 32 clients against a Python "
          f"http.server answering a constant document: {yard['rps']:.1f} requests/s, p50 "
          f"{yard['p50'] * 1e3:.3f} ms, p99 {yard['p99'] * 1e3:.3f} ms", flush=True)
    if flips:
        problems.append(f"{flips} answers neither the expected one nor the posture")
    fallback = metric_total(text, "cedar_authorizer_fallback_batches_total")
    res = {f: metric_total(text, f) - metric_total(text0, f) for f in RESILIENCE_FAMILIES}
    print(f"resilience metrics over the phase: {json.dumps(res)}, fallback batches "
          f"{fallback:g} (answered with the posture); launches {json.dumps(launches)}; "
          f"staging {json.dumps(staging)}", flush=True)
    if res["cedar_supervisor_restarts_total"] != 1:
        problems.append(f"{res['cedar_supervisor_restarts_total']:g} supervisor restarts, want 1")
    if not all(launches.values()):
        problems.append(f"a kernel was not launched in the phase: {launches}")
    print(f"resilience phase wall time ({card}): {time.monotonic() - t_phase:.1f} s",
          flush=True)
    if problems:
        fail("resilience: " + "; ".join(problems))
    return launches


def resilience_then(args, card: str):
    """Phase 11 as the continuation reload_phase runs on its server."""
    return lambda srv, pools, want, keyf: resilience_phase(args, card, srv, pools, want, keyf)


_YARDSTICK_SERVER = r"""
import json, sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
DOC = json.dumps({"status": {"allowed": False, "denied": False, "reason": "",
                             "evaluationError": "evaluation error: device breaker open"},
                  "response": {"uid": "", "allowed": True, "status": {"code": 500}}}).encode()
class Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 1024
class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *args):
        pass
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(DOC)))
        self.end_headers()
        self.wfile.write(DOC)
Server(("127.0.0.1", int(sys.argv[1])), Handler).serve_forever()
"""


def http_yardstick(pools: dict) -> dict:
    """The HTTP layer's own bound on this host: phase 11's clients (32 +
    32, closed loop) against a Python http.server (the webhook's server
    class) that answers a constant document and does nothing else, for
    3 s after 1 s of warm-up."""
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-c", _YARDSTICK_SERVER, str(port)])
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=1):
                    break
            except OSError:
                if time.monotonic() > deadline:
                    fail("the yardstick server did not listen within 30 s")
                time.sleep(0.1)
        traffic = Traffic(port, pools)
        traffic.start()
        time.sleep(1.0)
        t0 = time.time()
        time.sleep(3.0)
        t1 = time.time()
        traffic.stop()
        if traffic.errors:
            fail(f"yardstick: client errors {traffic.errors[:3]}")
        lat = [r[5] for r in traffic.records if t0 <= r[1] < t1]
        return {"rps": len(lat) / (t1 - t0), "p50": pct(lat, 50), "p99": pct(lat, 99)}
    finally:
        proc.kill()
        proc.wait(timeout=30)


POLICIES_PATH = "/apis/cedar.k8s.aws/v1alpha1/policies"


class FakeApiServer:
    """A standard-library stand-in for the kube-apiserver's Policy CRD
    endpoints (cedar.k8s.aws/v1alpha1), over plain HTTP on 127.0.0.1, port
    0. ``GET .../policies`` lists every object with the list's
    ``metadata.resourceVersion``; ``?watch=true&resourceVersion=N`` streams
    each event after N as one JSON object per line, flushed per event,
    and holds the stream open for later events up to ``hold_s`` (then
    closes it; a client reconnects from its last version); a watch from a
    version at or before the compaction point answers 410 Gone. apply() /
    touch() / delete() make ADDED / MODIFIED / DELETED events; expire()
    compacts every version before now and closes the open streams, so the
    next watch is refused and the client relists."""

    def __init__(self, hold_s: float = 5.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.hold_s = hold_s
        self.rv = 1
        self.items: dict = {}  # name -> Policy object document
        self.events: list = []  # (resourceVersion, watch event)
        self.compacted = 0
        self.epoch = 0  # bumped to close the open watch streams
        self.list_calls = 0
        self.watches: list = []  # resourceVersion of each watch request
        self.cond = threading.Condition()
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"  # a stream ends when it closes

            def log_message(self, *args):
                pass

            def _json(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                url = urlsplit(self.path)
                if url.path != POLICIES_PATH:
                    self._json(404, {"kind": "Status", "code": 404})
                    return
                query = parse_qs(url.query)
                if query.get("watch") == ["true"]:
                    api._watch(self, query.get("resourceVersion", [""])[0])
                    return
                with api.cond:
                    api.list_calls += 1
                    doc = {"kind": "PolicyList",
                           "metadata": {"resourceVersion": str(api.rv)},
                           "items": list(api.items.values())}
                self._json(200, doc)

        class Server(ThreadingHTTPServer):
            daemon_threads = True

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def kubeconfig(self, path: str) -> str:
        """Write a JSON kubeconfig for this server to `path`."""
        cfg = {"apiVersion": "v1", "kind": "Config", "current-context": "fake",
               "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
               "clusters": [{"name": "fake",
                             "cluster": {"server": f"http://127.0.0.1:{self.port}"}}],
               "users": [{"name": "fake", "user": {"token": "fake-token"}}]}
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path

    def _watch(self, handler, since: str) -> None:
        with self.cond:
            self.watches.append(since)
            if since and int(since) <= self.compacted:
                refused = True
            else:
                refused = False
                rv = int(since) if since else self.rv
                epoch = self.epoch
        if refused:
            handler._json(410, {"kind": "Status", "code": 410, "reason": "Expired"})
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.end_headers()
        deadline = time.monotonic() + self.hold_s
        while True:
            with self.cond:
                pending = [(r, e) for r, e in self.events if r > rv]
                while not pending and self.epoch == epoch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return
                    self.cond.wait(left)
                    pending = [(r, e) for r, e in self.events if r > rv]
                if self.epoch != epoch:
                    return
            try:
                for r, event in pending:
                    handler.wfile.write(json.dumps(event).encode() + b"\n")
                    handler.wfile.flush()
                    rv = r
            except OSError:
                return

    def _emit(self, kind: str, doc: dict) -> None:
        with self.cond:
            self.rv += 1
            doc = json.loads(json.dumps(doc))
            doc["metadata"]["resourceVersion"] = str(self.rv)
            if kind == "DELETED":
                self.items.pop(doc["metadata"]["name"], None)
            else:
                self.items[doc["metadata"]["name"]] = doc
            self.events.append((self.rv, {"type": kind, "object": doc}))
            self.cond.notify_all()

    def apply(self, name: str, content: str, labels=None, uid: str = "") -> None:
        """Create or replace a Policy object (ADDED / MODIFIED)."""
        with self.cond:
            old = self.items.get(name)
        meta = {"name": name, "uid": uid or (old["metadata"]["uid"] if old else f"uid-{name}")}
        if labels:
            meta["labels"] = dict(labels)
        self._emit("MODIFIED" if old else "ADDED", {
            "apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "Policy", "metadata": meta,
            "spec": {"content": content}})

    def touch(self, name: str) -> None:
        """A metadata-only MODIFIED: a new resourceVersion and annotation,
        the same uid and content."""
        with self.cond:
            doc = json.loads(json.dumps(self.items[name]))
        doc["metadata"].setdefault("annotations", {})["touched"] = str(time.time())
        self._emit("MODIFIED", doc)

    def delete(self, name: str) -> None:
        with self.cond:
            doc = self.items[name]
        self._emit("DELETED", doc)

    def expire(self) -> None:
        """Compact every version up to now and close the open streams: the
        next watch from a version the client holds answers 410."""
        with self.cond:
            self.rv += 1
            self.compacted = self.rv - 1
            self.epoch += 1
            self.cond.notify_all()

    def shutdown(self) -> None:
        with self.cond:
            self.epoch += 1
            self.cond.notify_all()
        self.httpd.shutdown()
        self.httpd.server_close()


# phase 12's edits: event 1 replaces the first policy of one 10-policy
# object with a forbid on every list (some SAR answers change); event 2
# adds a one-policy object with phase 10's forbid as one policy (every
# watch SAR, every admission delete); event 3 deletes it
CRD_EDIT_POLICY = 'forbid (principal, action == k8s::Action::"list", resource is k8s::Resource);'
CRD_FLIP_POLICY = ('forbid (principal, action in [k8s::Action::"watch", '
                   'k8s::admission::Action::"delete"], resource);\n')
CRD_EDITED, CRD_FLIP = "synth-0007", "flip"


def crd_objects(n_policies: int, seed: int) -> dict:
    """Phase 12's Policy objects {name: content}: synth_corpus(n, seed)'s
    policies in objects of 10 (synth-0000, synth-0001, ...), the gated
    policies of phase 8 in one object and the admission policies of phase
    9 in one."""
    from cedar_tpu_torch.corpus.synth import synth_source

    lines = synth_source(n_policies, seed=seed).split("\n")
    objs = {f"synth-{k:04d}": "\n".join(lines[i:i + 10]) + "\n"
            for k, i in enumerate(range(0, len(lines), 10))}
    objs["gated"] = FALLBACK_POLICY + NATIVE_OPAQUE_POLICY
    objs["admission"] = ADM_POLICIES + ADM_DEMO_OWNER_POLICY + ADM_FALLBACK_POLICY
    return objs


def window_stats(records: list, path: str, lo: float, hi: float) -> str:
    """requests/s, p99 and max of the answers of `path` done in [lo, hi)."""
    lat = [r[5] for r in records if r[2] == path and lo <= r[1] < hi]
    return (f"{len(lat) / max(hi - lo, 1e-9):.1f} requests/s p99 "
            f"{pct(lat, 99) * 1e3 if lat else float('nan'):.3f} ms max "
            f"{max(lat, default=float('nan')) * 1e3:.3f} ms")


def crd_full_lowers(vfile: str, buckets: int) -> dict:
    """Phase 12's yardstick for an event's lower: each engine's tiers at
    version 0 (the CRD store fed the objects of `vfile`; the admission
    engine's with the allow-all tier) lowered in full, shard by shard as
    the server's first load lowers them, in this process with the cyclic
    collector paused as the server's loads run -> {engine: seconds}."""
    import gc

    from cedar_tpu_torch.compiler.lower import AUTHZ_SCHEMA_INFO
    from cedar_tpu_torch.compiler.shard import ShardCompiler
    from cedar_tpu_torch.server.admission import allow_all_admission_policy_store
    from cedar_tpu_torch.stores.crd import CRDPolicyStore

    with open(vfile) as f:
        store = CRDPolicyStore(source=_ListedObjects(json.load(f)))
    while not store.initial_policy_load_complete():
        time.sleep(0.01)
    store.close()
    ps = store.policy_set()
    out = {}
    for p, tiers in (("authorization", [ps]),
                     ("admission", [ps, allow_all_admission_policy_store().policy_set()])):
        gc.disable()
        try:
            _, info = ShardCompiler(AUTHZ_SCHEMA_INFO, buckets=buckets).compile(tiers)
        finally:
            gc.enable()
        if info["compile_scope"] != "full":
            fail(f"crd: the yardstick lower of the {p} tiers was {info['compile_scope']}")
        out[p] = info["phase_seconds"]["lower"]
    return out


def crd_phase(args, card: str, sars: list) -> dict:
    """Phase 12 (module docstring): `sars` are phase 8's gated SAR bodies.
    Returns the server's kernel launch counts over the phase's traffic
    (its served counts: they start at 0, warm-ups count apart)."""
    t_phase = time.monotonic()
    grace = 5.0
    n_pool = 256  # 512 until the offline toolchain's slice needed the time
    pools = {"/v1/authorize": sars[:n_pool], "/v1/admit": admission_bodies(n_pool, args.seed + 10)}
    base = crd_objects(args.policies, args.seed)
    _head, rest = base[CRD_EDITED].split("\n", 1)
    edited = {**base, CRD_EDITED: CRD_EDIT_POLICY + "\n" + rest}
    # versions 0..3: the base, object edited, + the flip object, and
    # version 1 again (events 4 and 5 change no content)
    versions = [base, edited, {**edited, CRD_FLIP: CRD_FLIP_POLICY}, edited]
    api = FakeApiServer(hold_s=30.0)
    with tempfile.TemporaryDirectory(prefix="cedar-crd-") as tmp:
        vfiles = []
        for k in range(3):
            vfiles.append(os.path.join(tmp, f"v{k}.json"))
            with open(vfiles[-1], "w") as f:
                json.dump([{"metadata": {"name": n, "uid": f"uid-{n}"}, "spec": {"content": c}}
                           for n, c in versions[k].items()], f)
        for name, content in base.items():
            api.apply(name, content)
        kube = api.kubeconfig(os.path.join(tmp, "kubeconfig.json"))
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "crd", "crdStore": {}}]}}, f)
        # phase 10's serving flags (a 10 s budget; the CLI's breaker and
        # supervisor defaults), incremental compile at its defaults (64
        # buckets)
        srv = Webhook(cfg, tmp, "webhook-crd", grace,
                      ("--kubeconfig", kube, "--reload-seconds", "1",
                       "--request-timeout-ms", "10000", "--shard-buckets", "64"))
        traffic = None
        try:
            t0 = time.monotonic()
            tasks = {}
            for k in range(3):
                tasks[(k, "/v1/authorize")] = (f"crd-authorize:{vfiles[k]}", pools["/v1/authorize"])
                tasks[(k, "/v1/admit")] = (f"crd-admit:{vfiles[k]}", pools["/v1/admit"])
            # one piece per (version, endpoint): a worker builds one oracle
            answers = interpreter_answers(tasks, args.policies, args.seed, piece=n_pool)
            keyf = {"/v1/authorize": lambda a: reason_key(a, {}), "/v1/admit": adm_key}
            oracle_of = {"/v1/authorize": lambda a: a, "/v1/admit": lambda a: a["response"]}
            want = {path: [[keyf[path](oracle_of[path](a)) for a in answers[(k % 3, path)]]
                           for k in (0, 1, 2, 1)]
                    for path in pools}
            print(f"crd oracle: {len(tasks) * n_pool} interpreter answers over 3 versions of "
                  f"{len(base)} Policy objects in {time.monotonic() - t0:.1f} s", flush=True)
            for path in want:
                for k in (1, 2, 3):
                    n = sum(a != b for a, b in zip(want[path][k], want[path][k - 1]))
                    print(f"crd version {k} changes {n} of {n_pool} {path} answers", flush=True)
            srv.wait_ready(card)

            def engines():
                doc = srv.debug_engine()
                return {p: doc[p]["engine"] for p in ("authorization", "admission")}

            eng0 = engines()
            first = {p: eng0[p]["last_load"] for p in eng0}
            for p, e in eng0.items():
                print(f"crd {p} engine ({card}): L={e['L']} R={e['R']}, {e['shards']['shards']} "
                      f"shards, first load {first[p]['compile_scope']} compile seconds "
                      f"{json.dumps(first[p]['compile_seconds'])}", flush=True)
                if first[p]["compile_scope"] != "full":
                    fail(f"crd: {p} engine first load {first[p]['compile_scope']}, want full")
                if args.policies == 10000 and (e["L"], e["R"]) != (6144, 10240):
                    fail(f"crd: {p} engine at L={e['L']} R={e['R']}, want phase 10's width "
                         "L=6144 R=10240")
            if any(eng0["authorization"]["launches"].values()):
                fail(f"crd: served launches before traffic: {eng0['authorization']['launches']}")

            traffic = Traffic(srv.port, pools)
            traffic.start()
            # each engine's full lower, timed here under the same 32 + 32
            # clients, ahead of the 5 s before event 1: an event's
            # incremental lower is held to a quarter of it
            full_lower = crd_full_lowers(vfiles[0], 64)
            print(f"crd full lower under the clients ({card}), s: {json.dumps(full_lower)}",
                  flush=True)
            time.sleep(6.0)
            problems = []  # every check's failure, reported together at the end
            events = [("modify", lambda: api.apply(CRD_EDITED, edited[CRD_EDITED]), 10),
                      ("add", lambda: api.apply(CRD_FLIP, CRD_FLIP_POLICY), 1),
                      ("delete", lambda: api.delete(CRD_FLIP), 1),
                      ("metadata-only", lambda: api.touch("admission"), None),
                      ("relist", api.expire, None)]
            times, publishes, mem, launch_marks = [], [], {}, []
            for k, (label, fire, max_dirty) in enumerate(events, start=1):
                gens = {p: e["load_generation"] for p, e in engines().items()}
                lists = api.list_calls
                t_event = time.time()
                fire()
                times.append(t_event)
                if max_dirty is None:
                    # no content change: wait for the relist (event 5),
                    # then three reloader ticks
                    deadline = time.monotonic() + 60
                    while label == "relist" and api.list_calls <= lists:
                        if time.monotonic() > deadline:
                            fail(f"crd event {k} ({label}): the store did not relist in 60 s")
                        time.sleep(0.1)
                    time.sleep(3.5)
                    eng = engines()
                    stepped = {p: eng[p]["load_generation"] - gens[p] for p in gens}
                    print(f"crd event {k} ({label}, {card}): generations stepped {stepped} in "
                          f"{time.time() - t_event:.3f} s (list calls {lists} -> "
                          f"{api.list_calls})", flush=True)
                    if any(stepped.values()):
                        problems.append(f"event {k} ({label}) reloaded: {stepped}")
                    continue
                deadline = time.monotonic() + 60
                while True:
                    eng = engines()
                    if all(eng[p]["load_generation"] > gens[p] for p in gens):
                        break
                    if traffic.errors or time.monotonic() > deadline:
                        fail(f"crd event {k} ({label}): the engines did not step within 60 s "
                             f"(generations {gens}, client errors {traffic.errors[:3]}):\n"
                             f"{srv.log()}")
                    time.sleep(0.1)
                if any(eng[p]["load_generation"] != gens[p] + 1 for p in gens):
                    problems.append(f"event {k}: a generation stepped twice")
                publishes.append({p: eng[p]["last_load"] for p in eng})
                launch_marks.append(eng["authorization"]["launches"])
                for p in ("authorization", "admission"):
                    last = eng[p]["last_load"]
                    full10 = [c for r, q, c in PHASE10_COMPILE if q == p]
                    print(f"crd event {k} ({label}) {p} engine ({card}): event to swap "
                          f"{last['published_unix'] - t_event:.3f} s, {last['compile_scope']} "
                          f"compile, {last['dirty_shards']} of {last['shards']} shards dirty, "
                          f"compile seconds {json.dumps(last['compile_seconds'])}; first full "
                          f"load {json.dumps(first[p]['compile_seconds'])}; phase 10's full "
                          f"reloads {json.dumps(full10) if full10 else 'not run'}", flush=True)
                    if last["compile_scope"] != "incremental":
                        problems.append(f"event {k} {p}: {last['compile_scope']} compile")
                    if last["dirty_shards"] > max_dirty:
                        problems.append(f"event {k} {p}: {last['dirty_shards']} dirty shards, "
                                        f"more than the object's {max_dirty} policies")
                    if last["compile_seconds"]["lower"] >= full_lower[p] / 4:
                        problems.append(
                            f"event {k} {p}: lower {last['compile_seconds']['lower']} s, not "
                            f"below a quarter of the full lower under the same clients "
                            f"({full_lower[p]:.4f} s)")
                time.sleep(4.0)
                if k in (1, 3):
                    # read once the batches in flight at the swap, which
                    # hold the retired plane until they answer, are done
                    dm = engines()["authorization"]["device_memory"]
                    mem[k] = {"nvidia-smi": gpu_memory_mib(srv.proc.pid),
                              "allocated": dm["allocated"] / 2**20,
                              "reserved": dm["reserved"] / 2**20}
            launch_marks.append(engines()["authorization"]["launches"])
            traffic.stop()
            if traffic.errors:
                fail(f"crd: client errors {traffic.errors[:3]}")

            # every answer is that of a version live while it was in flight
            engine_of = {"/v1/authorize": "authorization", "/v1/admit": "admission"}
            flips = 0
            for path in pools:
                pubs = [pb[engine_of[path]]["published_unix"] for pb in publishes]
                bounds = [float("-inf")] + pubs + [float("inf")]
                odd, n = {}, 0
                for sent, done, rpath, i, got, _dt in traffic.records:
                    if rpath != path:
                        continue
                    n += 1
                    live = [v for v in range(4) if bounds[v] < done and bounds[v + 1] > sent]
                    if not any(keyf[path](got) == want[path][v][i] for v in live):
                        flips += 1
                        kind = "deadline" if "deadline of" in json.dumps(got) else "other"
                        at = odd.setdefault(f"version {live[-1]}", {})
                        at[kind] = at.get(kind, 0) + 1
                        if flips <= 3:
                            print(f"crd flip {path} body {i}: live versions {live}, got "
                                  f"{json.dumps(got)}", flush=True)
                print(f"crd {path}: {n} answers; answers of no live version "
                      f"{json.dumps(odd) if odd else 0}", flush=True)
            print(f"crd flips: {flips}", flush=True)
            if flips:
                problems.append(f"{flips} answers are no version's live while in flight")

            # serving in the 5 s before each event, while each reload
            # compiled, and in the 5 s after the events that reload nothing
            for k, t_event in enumerate(times, start=1):
                for path in pools:
                    row = [f"before {window_stats(traffic.records, path, t_event - 5.0, t_event)}"]
                    if k <= len(publishes):
                        pub = publishes[k - 1]
                        c0 = min(pub[p]["started_unix"] for p in pub)
                        c1 = max(pub[p]["published_unix"] for p in pub)
                        row.append(f"compiling {window_stats(traffic.records, path, c0, c1)} "
                                   f"(compile window {c1 - c0:.3f} s)")
                    else:
                        row.append(f"after {window_stats(traffic.records, path, t_event, t_event + 5.0)}")
                    print(f"crd event {k} {path} ({card}): {'; '.join(row)}", flush=True)

            for k in range(len(publishes)):
                a, b = launch_marks[k], launch_marks[k + 1]
                if not all(b[n] > a[n] for n in a):
                    problems.append(f"event {k + 1}: launches did not rise after the swap: "
                                    f"{a} -> {b}")
            launches = launch_marks[-1]
            text = http_get(srv.mport, "/metrics")[1].decode()
            fallback = metric_total(text, "cedar_authorizer_fallback_batches_total")
            shard_lines = [line for line in text.splitlines()
                           if line.startswith(("cedar_policy_shards{", "cedar_dirty_shards{",
                                               'cedar_compile_seconds_count{phase="hash"'))]
            print(f"crd launches {json.dumps(launches)}, fallback batches {fallback:g}, "
                  f"{'; '.join(shard_lines)}", flush=True)
            if fallback:
                problems.append(f"{fallback:g} fallback batches")
            problems += resilience_quiet("crd", text)
            plane = max(e["device_bytes"] for e in engines().values()) / 2**20
            print(f"crd card memory of the server, MiB ({card}; nvidia-smi's per-process figure "
                  f"where it lists the server, and the server's allocator): after reload 1 "
                  f"{json.dumps(mem[1])}, after reload 3 {json.dumps(mem[3])}; one plane "
                  f"{plane:.1f} MiB", flush=True)
            for what in ("nvidia-smi", "allocated", "reserved"):
                if mem[1][what] is not None and mem[3][what] - mem[1][what] > plane:
                    problems.append(f"card memory ({what}) grew by "
                                    f"{mem[3][what] - mem[1][what]:.1f} MiB over reloads 2-3, "
                                    f"more than one plane ({plane:.1f} MiB)")
            if problems:
                fail("crd: " + "; ".join(problems))
            took, rss = srv.terminate()
            print(f"crd webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
            print(f"crd phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
        finally:
            if traffic is not None:
                traffic.stop()
            srv.kill()
            api.shutdown()
    return launches


# phase 13's directory edit: a forbid on every watch (policy0, which
# partial mode keeps) and the interpreter-fallback policy (policy1, a
# clause_limit finding: strict rejects the edit, partial drops it)
GATE_EDIT_FORBID = 'forbid (principal, action == k8s::Action::"watch", resource is k8s::Resource);\n'
GATE_EDIT = GATE_EDIT_FORBID + FALLBACK_POLICY
# phase 13's CRD tier: one Policy object, then the same name carrying the
# interpreter-fallback policy (strict quarantines it)
GATE_OBJECT = "gate-probe"
GATE_OBJECT_POLICY = ('permit (principal, action == k8s::Action::"get", resource is '
                      'k8s::Resource) when { resource.resource == "gate-probes" };\n')


def _tiered_oracle(spec_path: str):
    """The interpreter authorizer over phase 13's tiers: the directory
    store of spec["dir"], then a CRD store fed spec["objects"]."""
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.stores.crd import CRDPolicyStore
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
    from cedar_tpu_torch.stores.store import TieredPolicyStores

    with open(spec_path) as f:
        spec = json.load(f)
    crd = CRDPolicyStore(source=_ListedObjects(spec["objects"]))
    while not crd.initial_policy_load_complete():
        time.sleep(0.01)
    crd.close()
    return CedarWebhookAuthorizer(TieredPolicyStores(
        [DirectoryPolicyStore(spec["dir"], start_ticker=False), crd]))


def gate_cost(card: str, corpus) -> None:
    """Phase 13's first part: the port's analyze_tiers alone on this host
    over the phase's authorization tier (the corpus and both gated
    policies), each pass timed, then the whole call; with the cyclic
    collector paused, as the server runs its loads."""
    import gc

    enabled = gc.isenabled()
    gc.disable()
    try:
        _gate_cost(card, corpus)
    finally:
        if enabled:
            gc.enable()


def _gate_cost(card: str, corpus) -> None:
    from cedar_tpu_torch.analysis import analyze as an

    tiers = [gated_policy_set(corpus)]
    t = time.perf_counter()
    infos = an.lower_all(tiers)
    secs = {"lower_all": time.perf_counter() - t}
    t = time.perf_counter()
    an.lint_lowerability(infos)
    secs["lint_lowerability"] = time.perf_counter() - t
    budget = an._Budget(an.PAIR_BUDGET)
    t = time.perf_counter()
    shadow = an.find_shadowing(infos, budget)
    secs["find_shadowing"] = time.perf_counter() - t
    t = time.perf_counter()
    an.find_conflicts(infos, budget, frozenset(
        f.policy_id for f in shadow if f.code == "unreachable_permit"))
    secs["find_conflicts"] = time.perf_counter() - t
    t = time.perf_counter()
    an.capacity_report(infos, len(tiers))
    secs["capacity_report"] = time.perf_counter() - t
    t = time.perf_counter()
    report = an.analyze_tiers(tiers)
    whole = time.perf_counter() - t
    print(f"gate cost ({card}; host clock): analyze_tiers over {len(tiers[0])} policies "
          f"in {whole:.4f} s; passes (s) "
          f"{json.dumps({k: round(v, 4) for k, v in secs.items()})}; truncated "
          f"{report.truncated}, budget left {budget.left}, findings "
          f"{json.dumps(report.counts(), sort_keys=True)}", flush=True)
    if report.counts().get("clause_limit") != 1 or (len(tiers[0]) > 10000
                                                     and not report.truncated):
        fail(f"gate cost: truncated {report.truncated}, findings {report.counts()}: want the "
             "gated set's one clause_limit finding and, at 10k policies, the pair budget "
             "spent")


def gate_phase(args, card: str, corpus, sars: list) -> dict:
    """Phase 13 (module docstring): `sars` are phase 8's gated SAR bodies.
    Returns the kernel launch counts of the phase's main path: both
    servers' served launches over the phase's traffic and the partial
    server's gated reload's warm-up launches."""
    from cedar_tpu_torch.corpus.synth import synth_source

    t_phase = time.monotonic()
    gate_cost(card, corpus)
    grace = 5.0
    n_pool = 256  # 512 until the offline toolchain's slice needed the time
    sars = sars[:n_pool]
    base = {"synth.cedar": synth_source(args.policies, seed=args.seed),
            "gated.cedar": NATIVE_OPAQUE_POLICY}
    launches = {"match_groups_kernel": 0, "match_words_kernel": 0}
    # one fake apiserver per server: the strict server's CRD events reach
    # no other server
    apis = {mode: FakeApiServer(hold_s=30.0) for mode in ("strict", "partial")}
    api = apis["strict"]
    with tempfile.TemporaryDirectory(prefix="cedar-gate-") as tmp:
        # v0: the base; v1: the base and the edit, as served; trimmed: what
        # partial mode compiles of v1 (the oracle's directory)
        vdirs = {}
        for name, files in (("v0", base), ("v1", {**base, "gate-edit.cedar": GATE_EDIT}),
                            ("trimmed", {**base, "gate-edit.cedar": GATE_EDIT_FORBID})):
            vdirs[name] = os.path.join(tmp, name)
            os.mkdir(vdirs[name])
            for fname, text in files.items():
                with open(os.path.join(vdirs[name], fname), "w") as f:
                    f.write(text)
        objects = [{"metadata": {"name": GATE_OBJECT, "uid": f"uid-{GATE_OBJECT}"},
                    "spec": {"content": GATE_OBJECT_POLICY}}]
        specs = {}
        for name in ("v0", "trimmed"):
            specs[name] = os.path.join(tmp, f"oracle-{name}.json")
            with open(specs[name], "w") as f:
                json.dump({"dir": vdirs[name], "objects": objects}, f)

        def serve(mode: str):
            """A server over the directory (a symlink at v0) and the CRD
            store (its own fake apiserver) under --validation-mode
            `mode`."""
            apis[mode].apply(GATE_OBJECT, GATE_OBJECT_POLICY)
            kube = apis[mode].kubeconfig(os.path.join(tmp, f"kubeconfig-{mode}.json"))
            pol_dir = os.path.join(tmp, f"policies-{mode}")
            os.symlink(vdirs["v0"], pol_dir)
            cfg = os.path.join(tmp, f"store-config-{mode}.json")
            with open(cfg, "w") as f:
                json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                           "spec": {"stores": [
                               {"type": "directory", "directoryStore": {
                                   "path": pol_dir, "refreshInterval": "30s"}},
                               {"type": "crd", "crdStore": {}}]}}, f)
            srv = Webhook(cfg, tmp, f"webhook-gate-{mode}", grace,
                          ("--kubeconfig", kube, "--reload-seconds", "1",
                           "--request-timeout-ms", "10000", "--validation-mode", mode))

            def swap_to_v1():
                link = pol_dir + ".new"
                os.symlink(vdirs["v1"], link)
                os.replace(link, pol_dir)

            return srv, swap_to_v1

        # both servers start while the oracle pool answers (a start is
        # one process's compile); the partial one idles while the strict
        # one serves
        srv, swap = serve("strict")
        partial = serve("partial")
        try:
            t0 = time.monotonic()
            answers = interpreter_answers(
                {k: (f"gate-authorize:{specs[k]}", sars) for k in specs},
                args.policies, args.seed, piece=n_pool // 2)
            want = {k: [reason_key(a, {}) for a in answers[k]] for k in specs}
            changed = sum(a != b for a, b in zip(want["v0"], want["trimmed"]))
            print(f"gate oracle: {len(specs) * n_pool} interpreter answers in "
                  f"{time.monotonic() - t0:.1f} s; the edit (trimmed) changes {changed} of "
                  f"{n_pool}", flush=True)
            if not changed:
                fail("gate: the edit changes no answer of the pool")
        except BaseException:
            srv.kill()
            partial[0].kill()
            raise

        def engines(srv):
            doc = srv.debug_engine()
            return {p: doc[p]["engine"] for p in ("authorization", "admission")}

        def window(srv, label: str, expected: list) -> dict:
            """The pool from 16 clients, every answer held against
            `expected`; the routing and batch counts it moved."""
            before = http_get(srv.mport, "/metrics")[1].decode()
            wall, lat, got, errors = drive(srv.port, sars, 16)
            if errors:
                fail(f"gate {label}: client errors {errors[:3]}")
            flips = count_flips(f"gate {label}", [reason_key(g, {}) for g in got],
                                expected, lat)
            after = http_get(srv.mport, "/metrics")[1].decode()
            gated = (metric_values(after, "cedar_authorizer_row_routing_total", "row_class",
                                   "authorization").get("gated", 0)
                     - metric_values(before, "cedar_authorizer_row_routing_total", "row_class",
                                     "authorization").get("gated", 0))
            print(f"gate {label} ({card}): {len(sars)} answers from 16 clients in {wall:.3f} s, "
                  f"p99 {pct(lat, 99) * 1e3:.3f} ms, flips {flips}, gated rows {gated:g}",
                  flush=True)
            if flips:
                fail(f"gate {label}: {flips} answers differ from the interpreter's")
            return {"gated": gated, "text": after}

        def batches_of(text: str) -> float:
            return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                       if line.startswith('cedar_batch_occupancy_count{path="authorization"}'))

        def findings(srv, kind: str) -> float:
            text = http_get(srv.mport, "/metrics")[1].decode()
            return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                       if line.startswith(f'cedar_policy_analysis_findings_total{{kind="{kind}"}}'))

        def first_load(srv, mode: str):
            eng = engines(srv)
            for p, e in eng.items():
                last = e["last_load"]
                print(f"gate {mode} {p} engine ({card}): L={e['L']} R={e['R']}, first load "
                      f"{last['compile_scope']} compile seconds "
                      f"{json.dumps(last['compile_seconds'])}", flush=True)
                if args.policies == 10000 and (e["L"], e["R"]) != (6144, 10240):
                    fail(f"gate {mode}: {p} engine at L={e['L']} R={e['R']}, want L=6144 R=10240")
                if "analyze" not in last["compile_seconds"]:
                    fail(f"gate {mode}: {p} engine's first load ran no analysis")
            return eng

        def add_launches(srv):
            got = engines(srv)["authorization"]["launches"]
            adm = engines(srv)["admission"]["launches"]
            for k in launches:
                launches[k] += got[k] + adm[k]
            return got

        # ---- strict: the edit rejected, the poisoned object quarantined
        try:
            srv.wait_ready(card)
            eng0 = first_load(srv, "strict")
            gens = {p: e["load_generation"] for p, e in eng0.items()}
            window(srv, "strict v0", want["v0"])
            n_clause = findings(srv, "clause_limit")
            t_write = time.monotonic()
            swap()
            deadline = time.monotonic() + 60
            while findings(srv, "clause_limit") < n_clause + 2:
                if time.monotonic() > deadline:
                    fail(f"gate strict: the edit was not analyzed by both engines within 60 s:\n"
                         f"{srv.log()}")
                time.sleep(0.2)
            t_rejected = time.monotonic() - t_write
            time.sleep(5.0)  # five reloader ticks over the unchanged, rejected corpus
            analyzed = findings(srv, "clause_limit") - n_clause
            rejected_lines = sum("load rejected by policy analysis" in line
                                 for line in srv.log().splitlines())
            doc = json.loads(http_get(srv.mport, "/debug/analysis")[1])
            blocking = {p: sorted(f["policy"] for f in r["findings"] if f["severity"] == "error")
                        for p, r in doc.items()}
            eng = engines(srv)
            stepped = {p: eng[p]["load_generation"] - gens[p] for p in gens}
            print(f"gate strict edit ({card}): rejected {t_rejected:.3f} s after the write; "
                  f"clause_limit findings counted {analyzed:g} (one per engine) after 5 more "
                  f"ticks; rejection log lines {rejected_lines}; generations stepped {stepped}; "
                  f"/debug/analysis blocking {json.dumps(blocking)}", flush=True)
            if analyzed != 2 or rejected_lines != 2 or any(stepped.values()):
                fail("gate strict: the rejected corpus was analyzed more than once per engine, "
                     "or an engine reloaded")
            if blocking.get("authorization") != ["gate-edit.cedar.policy1"]:
                fail(f"gate strict: /debug/analysis names {blocking}, want the edit's policy1")
            window(srv, "strict after the rejected edit", want["v0"])
            # the CRD tier: a poisoned object is quarantined; a MODIFIED
            # back to the retained content is a no-op; a relist clears it
            api.apply(GATE_OBJECT, FALLBACK_POLICY)

            def quarantined() -> bool:
                doc = json.loads(http_get(srv.mport, "/debug/supervisor")[1])
                return any(e.get("name") == GATE_OBJECT
                           for e in doc["quarantine"]["objects"])

            deadline = time.monotonic() + 30
            while not quarantined():
                if time.monotonic() > deadline:
                    fail(f"gate strict: {GATE_OBJECT} was not quarantined within 30 s:\n"
                         f"{http_get(srv.mport, '/debug/supervisor')[1][:600]!r}")
                time.sleep(0.2)
            api.apply(GATE_OBJECT, GATE_OBJECT_POLICY)
            time.sleep(2.0)
            still = quarantined()
            lists = api.list_calls
            api.expire()
            deadline = time.monotonic() + 60
            while api.list_calls <= lists or quarantined():
                if time.monotonic() > deadline:
                    fail(f"gate strict: the relist did not clear {GATE_OBJECT}'s quarantine "
                         "within 60 s")
                time.sleep(0.2)
            time.sleep(3.0)
            eng = engines(srv)
            stepped = {p: eng[p]["load_generation"] - gens[p] for p in gens}
            print(f"gate strict CRD ({card}): {GATE_OBJECT} quarantined on the poisoned "
                  f"MODIFIED, still quarantined after a MODIFIED back to its content: {still}; "
                  f"cleared by the relist (list calls {lists} -> {api.list_calls}); generations "
                  f"stepped {stepped}", flush=True)
            if not still or any(stepped.values()):
                fail("gate strict CRD: the quarantine or the generations moved unexpectedly")
            window(srv, "strict after the relist", want["v0"])
            text = http_get(srv.mport, "/metrics")[1].decode()
            problems = resilience_quiet("gate strict", text)
            if problems:
                fail("; ".join(problems))
            strict_launches = add_launches(srv)
            took, rss = srv.terminate()
            print(f"gate strict webhook: launches {json.dumps(strict_launches)}; SIGTERM -> "
                  f"exit code 0 in {took:.2f} s; peak RSS ({card}): {rss}", flush=True)
        except BaseException:
            partial[0].kill()
            raise
        finally:
            srv.kill()

        # ---- partial: the edit loads without the offending policy
        srv, swap = partial
        try:
            srv.wait_ready(card)
            eng0 = first_load(srv, "partial")
            gens = {p: e["load_generation"] for p, e in eng0.items()}
            text0 = http_get(srv.mport, "/metrics")[1].decode()
            w0 = window(srv, "partial v0", want["v0"])
            b0 = batches_of(w0["text"]) - batches_of(text0)
            launch0 = engines(srv)["authorization"]["launches"]
            warm0 = {p: e["warmup_launches"] for p, e in engines(srv).items()}
            t_write = time.time()
            swap()
            deadline = time.monotonic() + 60
            while True:
                eng = engines(srv)
                if all(eng[p]["load_generation"] > gens[p] for p in gens):
                    break
                if time.monotonic() > deadline:
                    fail(f"gate partial: the engines did not step within 60 s:\n{srv.log()}")
                time.sleep(0.2)
            for p in ("authorization", "admission"):
                last = eng[p]["last_load"]
                fb = eng[p].get("fallback", {})
                print(f"gate partial {p} engine ({card}): write to swap "
                      f"{last['published_unix'] - t_write:.3f} s, {last['compile_scope']} "
                      f"compile, {last['dirty_shards']} of {last['shards']} shards dirty, "
                      f"compile seconds {json.dumps(last['compile_seconds'])}; fallback "
                      f"policies {fb.get('policies')}", flush=True)
                if fb.get("policies") != 0:
                    fail(f"gate partial: the {p} plane carries {fb.get('policies')} fallback "
                         "policies, want 0 (the offending policy dropped)")
            text1 = http_get(srv.mport, "/metrics")[1].decode()
            w1 = window(srv, "partial after the edit (trimmed set)", want["trimmed"])
            b1 = batches_of(w1["text"]) - batches_of(text1)
            launch1 = engines(srv)["authorization"]["launches"]
            print(f"gate partial gated rows per batch ({card}): before the edit "
                  f"{w0['gated'] / max(b0, 1):.3f} ({w0['gated']:g} rows, {b0:g} batches), "
                  f"after {w1['gated'] / max(b1, 1):.3f} ({w1['gated']:g} rows, {b1:g} "
                  f"batches)", flush=True)
            # the gated reload warms its plane through both kernels before
            # the swap; served traffic then takes the words kernel only: a
            # plane the strict or partial gate admits holds no
            # interpreter-fallback policy, the one thing the groups kernel
            # serves
            warm = {k: sum(eng[p]["warmup_launches"][k] - warm0[p][k] for p in eng)
                    for k in launches}
            print(f"gate partial swap ({card}): the gated reload's warm-up launches "
                  f"{json.dumps(warm)}; served launches {json.dumps(launch0)} -> "
                  f"{json.dumps(launch1)}", flush=True)
            if not all(warm.values()) or launch1["match_words_kernel"] <= \
                    launch0["match_words_kernel"]:
                fail(f"gate partial: the gated reload's warm-up launched {warm}, served words "
                     f"launches {launch0} -> {launch1}: want both kernels warmed and the "
                     "words kernel serving after the swap")
            for k in launches:
                launches[k] += warm[k]
            doc = json.loads(http_get(srv.mport, "/debug/analysis")[1])
            dropped = sorted(f["policy"] for f in doc["authorization"]["findings"]
                             if f["severity"] == "error")
            if dropped != ["gate-edit.cedar.policy1"]:
                fail(f"gate partial: /debug/analysis blocking findings {dropped}")
            text = http_get(srv.mport, "/metrics")[1].decode()
            problems = resilience_quiet("gate partial", text)
            if problems:
                fail("; ".join(problems))
            partial_launches = add_launches(srv)
            took, rss = srv.terminate()
            print(f"gate partial webhook: launches {json.dumps(partial_launches)}; SIGTERM -> "
                  f"exit code 0 in {took:.2f} s; peak RSS ({card}): {rss}", flush=True)
        finally:
            srv.kill()
            for a in apis.values():
                a.shutdown()
    print(f"gate launches {json.dumps(launches)}; gate phase wall time ({card}): "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


def cache_working_set(sars: list, n: int) -> list:
    """The first `n` bodies of `sars` with distinct decision cache keys
    (canonical fingerprints)."""
    from cedar_tpu_torch.cache import fingerprint_body

    seen, out = set(), []
    for body in sars:
        key = fingerprint_body("authorize", body)
        if key is not None and key not in seen:
            seen.add(key)
            out.append(body)
            if len(out) == n:
                return out
    fail(f"cache: only {len(out)} distinct requests in a pool of {len(sars)}")


def policy_shards(objects: dict, buckets: int) -> dict:
    """{policy id: shard id} of a CRD store fed `objects` ({name:
    content}), as an incremental engine over one tier with `buckets`
    buckets files them (compiler/shard.py shard_bucket)."""
    from cedar_tpu_torch.compiler.shard import shard_bucket
    from cedar_tpu_torch.stores.crd import CRDPolicyStore

    store = CRDPolicyStore(source=_ListedObjects(
        [{"metadata": {"name": n, "uid": f"uid-{n}"}, "spec": {"content": c}}
         for n, c in objects.items()]))
    while not store.initial_policy_load_complete():
        time.sleep(0.01)
    store.close()
    return {p.policy_id: f"t0b{shard_bucket(p, buckets):04d}"
            for p in store.policy_set().policies()}


def cache_metrics(port: int) -> dict:
    """The authorization path's decision cache counters on /metrics."""
    text = http_get(port, "/metrics")[1].decode()
    out = {}
    for name in ("hits", "misses", "coalesced"):
        out[name] = metric_values(text, f"cedar_decision_cache_{name}_total", "path",
                                  "authorization").get("authorization", 0.0)
    for line in text.splitlines():
        if line.startswith('cedar_decision_cache_evictions_total{path="authorization"'):
            reason = line.split('reason="')[1].split('"')[0]
            out[f"evicted_{reason}"] = float(line.rsplit(" ", 1)[1])
    return out


def cache_phase(args, card: str, sars: list, flags=()) -> dict:
    """Phase 14 (module docstring): the decision cache in front of the
    CRD-served engines at the CLI's defaults. `sars` is phase 12's SAR
    pool. Returns the server's served kernel launches over the phase."""
    t_phase = time.monotonic()
    grace = 5.0
    # 1024 and 512 until the offline toolchain's slice needed the time
    n_keys, n_side, buckets = 512, 256, 64
    distinct = cache_working_set(sars, n_keys + n_side)
    # the working set, and the other keys the clients send during the
    # edit (entries they make after the swap are fresh, not survivors)
    bodies, side = distinct[:n_keys], distinct[n_keys:]
    base = crd_objects(args.policies, args.seed)
    _head, rest = base[CRD_EDITED].split("\n", 1)
    edited = {**base, CRD_EDITED: CRD_EDIT_POLICY + "\n" + rest}
    api = FakeApiServer(hold_s=30.0)
    with tempfile.TemporaryDirectory(prefix="cedar-cache-") as tmp:
        vfiles = []
        for k, version in enumerate((base, edited)):
            vfiles.append(os.path.join(tmp, f"v{k}.json"))
            with open(vfiles[-1], "w") as f:
                json.dump([{"metadata": {"name": n, "uid": f"uid-{n}"}, "spec": {"content": c}}
                           for n, c in version.items()], f)
        for name, content in base.items():
            api.apply(name, content)
        kube = api.kubeconfig(os.path.join(tmp, "kubeconfig.json"))
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "crd", "crdStore": {}}]}}, f)
        # phase 12's serving flags, the decision cache at the CLI's defaults
        srv = Webhook(cfg, tmp, "webhook-cache", grace,
                      ("--kubeconfig", kube, "--reload-seconds", "1",
                       "--request-timeout-ms", "10000", "--shard-buckets", str(buckets), *flags),
                      cache=True)
        traffic = None
        try:
            t0 = time.monotonic()
            answers = interpreter_answers(
                {(k, part): (f"crd-authorize:{vfiles[k]}", b) for k in (0, 1)
                 for part, b in (("set", bodies), ("side", side))},
                args.policies, args.seed, piece=128)
            want = [answers[(0, "set")], answers[(1, "set")]]
            want_side = [answers[(0, "side")], answers[(1, "side")]]
            changed = [i for i in range(n_keys) if want[0][i] != want[1][i]]
            shard_of = policy_shards(base, buckets)
            print(f"cache oracle: {2 * (n_keys + n_side)} interpreter answers over 2 versions in "
                  f"{time.monotonic() - t0:.1f} s; the edit changes {len(changed)} of "
                  f"{n_keys} answers", flush=True)
            srv.wait_ready(card)

            def engine():
                return srv.debug_engine()["authorization"]["engine"]

            def stats():
                return json.loads(http_get(srv.mport, "/debug/cache")[1])["authorization"]

            st = stats()
            if (st["max_entries"], st["ttl_seconds"]) != (
                    65536, {"allow": 300.0, "deny": 30.0, "no_opinion": 5.0}):
                fail(f"cache: not the CLI's defaults: {json.dumps(st)}")
            if any(engine()["launches"].values()):
                fail(f"cache: served launches before traffic: {engine()['launches']}")
            problems = []

            def window(label, win_bodies, expected, conc):
                """One window: answers held against `expected` (canon), the
                cache counters' and the served launches' deltas."""
                m0, l0 = cache_metrics(srv.mport), engine()["launches"]
                wall, lat, got, errors = drive(srv.port, win_bodies, conc)
                if errors:
                    fail(f"cache {label}: client errors {errors[:3]}")
                m1, l1 = cache_metrics(srv.mport), engine()["launches"]
                flips = [i for i, (g, e) in enumerate(zip(got, expected))
                         if canon({"status": g}) != e]
                for i in flips[:3]:
                    print(f"cache {label} flip: expected {json.dumps(expected[i])}, got "
                          f"{json.dumps(got[i])}", flush=True)
                if flips:
                    problems.append(f"{label}: {len(flips)} answers unlike the oracle's")
                dm = {k: m1.get(k, 0.0) - m0.get(k, 0.0) for k in m1}
                dl = {k: l1[k] - l0[k] for k in l1}
                print(f"cache {label} ({card}): {len(win_bodies)} requests at concurrency "
                      f"{conc}, {len(win_bodies) / wall:.1f} requests/s, p50 "
                      f"{pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms; "
                      f"cache {json.dumps(dm)}; launches {json.dumps(dl)}; flips {len(flips)}",
                      flush=True)
                return dm, dl

            # 1. warm pass: every key misses once and launches the kernels
            dm, dl = window("warm pass", bodies, want[0], 64)
            if dm["misses"] != n_keys or dm["hits"] != 0:
                problems.append(f"warm pass: {dm['misses']:g} misses, {dm['hits']:g} hits, "
                                f"want {n_keys} and 0")
            if not all(dl.values()):
                problems.append(f"warm pass: a kernel did not launch on the misses: {dl}")
            # the allow answers (300 s TTL) answer from the cache alone
            allow = [i for i in range(n_keys) if want[0][i]["allowed"]]
            dm, dl = window("allow hits", [bodies[i] for i in allow],
                            [want[0][i] for i in allow], 64)
            if dm["misses"] or any(dl.values()):
                problems.append(f"allow hits: {dm['misses']:g} misses, launches {dl}: want 0")
            # 2. repeat window: 4 shuffled passes at c=64 (8 until phase 21
            # needed the time), then 300 at c=1
            rng = random.Random(args.seed + 14)
            order = [i for _ in range(4) for i in rng.sample(range(n_keys), n_keys)]
            dm, dl = window("repeat c=64", [bodies[i] for i in order],
                            [want[0][i] for i in order], 64)
            if any(dl.values()) and not dm["misses"]:
                problems.append(f"repeat c=64: launches {dl} without a miss")
            if sum(dl.values()) > dm["misses"]:
                problems.append(f"repeat c=64: {sum(dl.values())} launches for "
                                f"{dm['misses']:g} misses")
            c1 = [allow[i % len(allow)] for i in range(300)]
            dm, dl = window("allow hits c=1", [bodies[i] for i in c1],
                            [want[0][i] for i in c1], 1)
            if dm["misses"] or any(dl.values()):
                problems.append(f"hits c=1: {dm['misses']:g} misses, launches {dl}: want 0")

            # 3. the edit: phase 12's event 1, under 16 clients on the
            # other keys
            gen = engine()["load_generation"]
            traffic = Traffic(srv.port, {"/v1/authorize": side}, per_path=16)
            traffic.start()
            time.sleep(2.0)
            t_event = time.time()
            api.apply(CRD_EDITED, edited[CRD_EDITED])
            deadline = time.monotonic() + 60
            while engine()["load_generation"] == gen:
                if traffic.errors or time.monotonic() > deadline:
                    fail(f"cache: the authorization engine did not swap within 60 s "
                         f"(client errors {traffic.errors[:3]}):\n{srv.log()}")
                time.sleep(0.1)
            eng = engine()
            last = eng["last_load"]
            time.sleep(2.0)
            traffic.stop()
            if traffic.errors:
                fail(f"cache: client errors {traffic.errors[:3]}")
            dirty = set(eng["shards"]["dirty"])
            print(f"cache edit ({card}): event to swap {last['published_unix'] - t_event:.3f} s, "
                  f"{last['compile_scope']} compile, {last['dirty_shards']} of "
                  f"{last['shards']} shards dirty, compile seconds "
                  f"{json.dumps(last['compile_seconds'])}", flush=True)
            stale = 0
            for sent, done, _path, i, got, _dt in traffic.records:
                key = canon({"status": got})
                if sent > last["published_unix"]:
                    stale += key != want_side[1][i]
                elif key not in (want_side[0][i], want_side[1][i]):
                    stale += 1
            print(f"cache edit window {window_stats(traffic.records, '/v1/authorize', t_event, last['published_unix'])} "
                  f"while compiling; {len(traffic.records)} answers, {stale} of no live version",
                  flush=True)
            if stale:
                problems.append(f"edit window: {stale} answers of no live version")

            # 4. post-edit pass, one request at a time: which keys hit
            hits = []
            before = cache_metrics(srv.mport)
            c = Client(srv.port)
            lat, flips = [], 0
            try:
                h0 = stats()["hits"]
                for i, body in enumerate(bodies):
                    got, dt = c.post(body)
                    lat.append(dt)
                    h1 = stats()["hits"]
                    if h1 > h0:
                        hits.append(i)
                    h0 = h1
                    if canon({"status": got}) != want[1][i]:
                        flips += 1
                        if flips <= 3:
                            print(f"cache post-edit flip body {i}: expected "
                                  f"{json.dumps(want[1][i])}, got {json.dumps(got)}", flush=True)
            finally:
                c.close()
            after = cache_metrics(srv.mport)
            hit = set(hits)

            def determining(i):
                r = want[0][i]["reason"]
                return [json.loads(x)["policy"] for x in r] if isinstance(r, list) else []

            in_dirty = [i for i in range(n_keys)
                        if any(shard_of.get(p) in dirty for p in determining(i))]
            unscoped = [i for i in range(n_keys) if not determining(i)]
            bad_dirty = sorted(hit & set(in_dirty))
            bad_unscoped = sorted(hit & set(unscoped))
            bad_changed = sorted(hit & set(changed))
            print(f"cache post-edit pass ({card}): {len(hits)} of {n_keys} keys answered from "
                  f"entries that survived the swap; {len(in_dirty)} keys decided in the dirty "
                  f"shards, {len(unscoped)} NoOpinion or unscoped, {len(changed)} changed by the "
                  f"edit; hits among them {len(bad_dirty)} / {len(bad_unscoped)} / "
                  f"{len(bad_changed)}; evictions "
                  f"{json.dumps({k: after[k] - before.get(k, 0.0) for k in after if k.startswith('evicted_')})}; "
                  f"p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms; "
                  f"flips {flips}", flush=True)
            if flips:
                problems.append(f"post-edit pass: {flips} stale or wrong answers")
            if bad_dirty or bad_unscoped or bad_changed:
                problems.append(f"post-edit pass: hits on keys the edit must re-evaluate "
                                f"(dirty {bad_dirty[:5]}, unscoped {bad_unscoped[:5]}, "
                                f"changed {bad_changed[:5]})")
            if not hits:
                problems.append("post-edit pass: no entry outside the dirty shards survived")
            launches = engine()["launches"]
            m = cache_metrics(srv.mport)
            st = stats()
            text = http_get(srv.mport, "/metrics")[1].decode()
            problems += resilience_quiet("cache", text)
            fallback = metric_total(text, "cedar_authorizer_fallback_batches_total")
            if fallback:
                problems.append(f"{fallback:g} fallback batches")
            print(f"cache totals ({card}): hit ratio {st['hit_ratio']:.4f}, hits {m['hits']:g}, "
                  f"misses {m['misses']:g}, coalesced {m['coalesced']:g}, size {st['size']}, "
                  f"launches {json.dumps(launches)}", flush=True)
            if not all(launches.values()):
                problems.append(f"a kernel did not launch: {launches}")
            if problems:
                fail("cache: " + "; ".join(problems))
            took, rss = srv.terminate()
            print(f"cache webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss} with {st['size']} entries", flush=True)
        finally:
            if traffic is not None:
                traffic.stop()
            srv.kill()
            api.shutdown()
    full_cache_bytes(card, bodies)
    print(f"cache phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


def full_cache_bytes(card: str, bodies: list) -> None:
    """The host memory of a full decision cache at the CLI's default size:
    65536 entries of this phase's answers under distinct keys, with the
    body -> fingerprint memo the server sizes like it, measured with
    tracemalloc in this process."""
    import tracemalloc

    from cedar_tpu_torch.cache import DecisionCache, FingerprintMemo

    tracemalloc.start()
    m0 = tracemalloc.get_traced_memory()[0]
    cache, memo = DecisionCache(), FingerprintMemo(capacity=65536)
    reason = ('{"reasons":[{"policy":"synth-00070-uid-synth-0007","position":'
              '{"filename":"synth-0007","offset":0,"line":1,"column":1}}]}')
    import hashlib

    for i in range(65536):
        memo.fingerprint("authorize", bodies[i % len(bodies)] + b" " * (i // len(bodies)))
        cache.put(hashlib.sha256(str(i).encode()).hexdigest()[:32], ("allow", reason), "allow")
    used = tracemalloc.get_traced_memory()[0] - m0
    tracemalloc.stop()
    print(f"cache full ({card}): {cache.size()} entries and {len(memo._memo)} memo rows hold "
          f"{used / 2**20:.1f} MiB of host memory (tracemalloc, this process)", flush=True)


# phase 15's injector rates (answers per second): unequal, so the two
# token buckets do not refill in step (with equal rates both fire on the
# same request and the deny, consulted second, hides every error)
OBS_ERROR_RATE, OBS_DENY_RATE = 2.0, 3.0
# an injected answer's status: NoOpinion with the injector's error, or a
# deny with its reason (chaos/registry.py Seam.fire)
INJECTED_ERROR = {"allowed": False, "denied": False, "reason": "",
                  "evaluationError": "encountered error"}
INJECTED_DENY = {"allowed": False, "denied": True, "reason": "Authorization denied"}


def drive_traced(port: int, items: list, concurrency: int, path: str = "/v1/authorize"):
    """drive() with headers: items are (body, traceparent or None) ->
    (wall s, [latency s], [answer], [response headers], [(unix send, unix
    done)], [client error])."""
    n = len(items)
    lat, got, hdrs, when = [0.0] * n, [None] * n, [None] * n, [None] * n
    errors, next_i, lock = [], [0], threading.Lock()

    def worker():
        c = Client(port, path)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= n:
                    return
                body, tp = items[i]
                sent = time.time()
                got[i], lat[i] = c.post(body, {"traceparent": tp} if tp else None)
                hdrs[i], when[i] = c.headers, (sent, time.time())
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish within 600 s")
    return wall, lat, got, hdrs, when, errors


def injections(port: int) -> dict:
    """cedar_chaos_injections_total{seam="response"} by kind."""
    text = http_get(port, "/metrics")[1].decode()
    out = {"response_error": 0.0, "response_deny": 0.0}
    for line in text.splitlines():
        if line.startswith('cedar_chaos_injections_total{') and 'seam="response"' in line:
            out[line.split('kind="')[1].split('"')[0]] = float(line.rsplit(" ", 1)[1])
    return out


def sar_label(status: dict) -> str:
    """The decision label a SAR answer is counted and audited under."""
    if status.get("evaluationError"):
        return "<error>"
    return "Allow" if status["allowed"] else "Deny" if status["denied"] else "NoOpinion"


def adm_label(resp: dict) -> str:
    """The label of an AdmissionReview response (server/http.py
    _admit_outcome)."""
    if resp["status"]["code"] not in (None, 200):
        return "<error>"
    return "allowed" if resp["allowed"] else "denied"


def obs_phase(args, card: str, sars: list, then=None):
    """Phase 15 (module docstring): the request observability plane around
    both webhook paths of the CLI over phase 12's Policy objects, with the
    cache at its defaults, the tracer at rate 1, the audit log, the
    recorder and the injector on, and a rollout control token. `sars` is
    phase 12's SAR pool. Returns the server's served kernel launches over
    the phase, both engines, and what ``then`` returned: phases 17 and 18
    (then_all), run on this server once phase 15's checks have passed."""
    from cedar_tpu_torch.obs.trace import parse_traceparent, span_tree_coverage

    t_phase = time.monotonic()
    grace = 5.0
    n_keys, n_c1, n_adm, n_hits = 1024, 100, 256, 300
    # past phase 15's keys: phase 17's fresh misses (BESIDE_N)
    distinct = cache_working_set(sars, n_keys + n_c1 + BESIDE_N)
    bodies, c1_bodies = distinct[:n_keys], distinct[n_keys:n_keys + n_c1]
    adm = admission_bodies(n_adm, args.seed + 9)
    base = crd_objects(args.policies, args.seed)
    api = FakeApiServer(hold_s=30.0)
    with tempfile.TemporaryDirectory(prefix="cedar-obs-") as tmp:
        vfile = os.path.join(tmp, "v0.json")
        with open(vfile, "w") as f:
            json.dump([{"metadata": {"name": n, "uid": f"uid-{n}"}, "spec": {"content": c}}
                       for n, c in base.items()], f)
        for name, content in base.items():
            api.apply(name, content)
        kube = api.kubeconfig(os.path.join(tmp, "kubeconfig.json"))
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "crd", "crdStore": {}}]}}, f)
        trace_log, audit_log = os.path.join(tmp, "traces.jsonl"), os.path.join(tmp, "audit.jsonl")
        rec_dir = os.path.join(tmp, "recordings")
        token_file = os.path.join(tmp, "rollout-token")
        with open(token_file, "w") as f:
            f.write(ROLLOUT_TOKEN + "\n")
        # phase 14's serving flags and cache defaults, the plane armed
        srv = Webhook(cfg, tmp, "webhook-obs", grace,
                      ("--kubeconfig", kube, "--reload-seconds", "1",
                       "--request-timeout-ms", "10000", "--shard-buckets", "64",
                       "--trace-sample-rate", "1.0", "--trace-ring", "4096",
                       "--trace-log-file", trace_log, "--audit-log-file", audit_log,
                       "--enable-recording", "--recording-dir", rec_dir,
                       "--confirm-non-prod-inject-errors",
                       "--artificial-error-rate", str(OBS_ERROR_RATE),
                       "--artificial-deny-rate", str(OBS_DENY_RATE),
                       "--rollout-control-token-file", token_file),
                      cache=True)
        try:
            t0 = time.monotonic()
            answers = interpreter_answers(
                {"set": (f"crd-authorize:{vfile}", bodies), "c1": (f"crd-authorize:{vfile}", c1_bodies),
                 "adm": (f"crd-admit:{vfile}", adm)},
                args.policies, args.seed, piece=128)
            want = {"set": answers["set"], "c1": answers["c1"]}
            want_adm = [a["response"] for a in answers["adm"]]
            print(f"obs oracle: {n_keys + n_c1 + n_adm} interpreter answers in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            srv.wait_ready(card)

            def launches():
                doc = srv.debug_engine()
                return {k: sum(doc[p]["engine"]["launches"][k]
                               for p in ("authorization", "admission"))
                        for k in doc["authorization"]["engine"]["launches"]}

            problems, requests = [], []  # requests: (window, path, body, answer, headers, sent tp)
            l_start = launches()

            def check_sars(label, items, got, expected, wall, inj0, inj1):
                """Flips: every answer unlike the oracle's must be an
                injected one, their count the injector's (a request both
                limiters fire on answers the deny), within rate x wall + 1
                per kind -> the indices of injected answers."""
                # no real answer has the injector's error or deny reason
                errs = [i for i, g in enumerate(got) if g == INJECTED_ERROR]
                denies = [i for i, g in enumerate(got) if g == INJECTED_DENY]
                flips = [i for i, g in enumerate(got) if g not in (INJECTED_ERROR, INJECTED_DENY)
                         and canon({"status": g}) != expected[i]]
                d_err = inj1["response_error"] - inj0["response_error"]
                d_deny = inj1["response_deny"] - inj0["response_deny"]
                both = d_err - len(errs)
                for i in flips[:3]:
                    print(f"obs {label} flip: expected {json.dumps(expected[i])}, got "
                          f"{json.dumps(got[i])}", flush=True)
                if flips:
                    problems.append(f"{label}: {len(flips)} flips beyond the injections")
                if d_deny != len(denies) or not 0 <= both <= len(denies):
                    problems.append(f"{label}: {len(errs)} injected errors and {len(denies)} "
                                    f"denies answered, the injector fired {d_err:g} / {d_deny:g}")
                for kind, n, rate in (("error", d_err, OBS_ERROR_RATE),
                                      ("deny", d_deny, OBS_DENY_RATE)):
                    if n > rate * wall + 1:
                        problems.append(f"{label}: {n:g} injected {kind}s in {wall:.3f} s at "
                                        f"{rate:g}/s")
                return set(errs) | set(denies), (len(errs), len(denies), both)

            def report(label, wall, lat, n, conc, extra=""):
                print(f"obs {label} ({card}): {n} requests at concurrency {conc}, "
                      f"{n / wall:.1f} requests/s, p50 {pct(lat, 50) * 1e3:.3f} ms, "
                      f"p99 {pct(lat, 99) * 1e3:.3f} ms{extra}", flush=True)

            # (a) misses: the working set at c=64 beside the admission
            # reviews at c=16; every 16th SAR and 8th review carries a
            # traceparent, whose id must come back
            items = []
            for i, b in enumerate(bodies):
                h = f"00-{i + 1:032x}-{i + 1:016x}-01" if i % 16 == 0 else None
                items.append((b, h))
            adm_items = [(b, f"00-{0xadd00000 + i:032x}-{i + 1:016x}-00" if i % 8 == 0 else None)
                         for i, b in enumerate(adm)]
            inj0, l0 = injections(srv.mport), launches()
            out = {}
            th = threading.Thread(target=lambda: out.update(
                adm=drive_traced(srv.port, adm_items, 16, "/v1/admit")))
            th.start()
            wall, lat, got, hdrs, when, errors = drive_traced(srv.port, items, 64)
            th.join(timeout=600)
            inj1, l1 = injections(srv.mport), launches()
            a_wall, a_lat, a_got, a_hdrs, _a_when, a_errors = out["adm"]
            if errors or a_errors:
                fail(f"obs (a): client errors {(errors + a_errors)[:3]}")
            window = max(w[1] for w in when) - min(w[0] for w in when)
            injected_a, counts = check_sars("(a) misses", items, got, want["set"], window, inj0, inj1)
            adm_flips = sum(adm_key(g) != adm_key(w) for g, w in zip(a_got, want_adm))
            if adm_flips:
                problems.append(f"(a) admission: {adm_flips} flips")
            dl = {k: l1[k] - l0[k] for k in l1}
            report("(a) misses", wall, lat, n_keys, 64,
                   f"; injected errors / denies / both-fired {list(counts)}; launches "
                   f"{json.dumps(dl)}")
            report("(a) admission", a_wall, a_lat, n_adm, 16, f"; flips {adm_flips}")
            if not all(dl.values()):
                problems.append(f"(a): a kernel did not launch: {dl}")
            requests += [("a", "/v1/authorize", b, g, h, t) for (b, t), g, h in zip(items, got, hdrs)]
            requests += [("a", "/v1/admit", b, g, h, t)
                         for (b, t), g, h in zip(adm_items, a_got, a_hdrs)]

            # (a') misses at c=1: the span breakdown of a lone miss
            c1_items = [(b, None) for b in c1_bodies]
            inj0, l0 = injections(srv.mport), launches()
            wall, lat, got, hdrs, when, errors = drive_traced(srv.port, c1_items, 1)
            inj1, l1 = injections(srv.mport), launches()
            if errors:
                fail(f"obs (a'): client errors {errors[:3]}")
            _inj_c1, counts_c1 = check_sars("(a') misses c=1", c1_items, got, want["c1"], wall,
                                            inj0, inj1)
            report("(a') misses c=1", wall, lat, n_c1, 1,
                   f"; injected {list(counts_c1)}; launches "
                   f"{json.dumps({k: l1[k] - l0[k] for k in l1})}")
            requests += [("c1", "/v1/authorize", b, g, h, None)
                         for (b, _), g, h in zip(c1_items, got, hdrs)]

            # (b) hits at c=1: the allow keys, those injected in (a) first
            allow = [i for i in range(n_keys) if want["set"][i]["allowed"]]
            first = [i for i in allow if i in injected_a]
            order = first + [i for i in allow if i not in injected_a]
            hit_idx = [order[k % len(order)] for k in range(n_hits)]
            hit_items = [(bodies[i], None) for i in hit_idx]
            inj0, l0 = injections(srv.mport), launches()
            wall, lat, got, hdrs, when, errors = drive_traced(srv.port, hit_items, 1)
            inj1, l1 = injections(srv.mport), launches()
            if errors:
                fail(f"obs (b): client errors {errors[:3]}")
            injected_b, counts_b = check_sars("(b) hits c=1", hit_items, got,
                                              [want["set"][i] for i in hit_idx], wall, inj0, inj1)
            dl = {k: l1[k] - l0[k] for k in l1}
            if any(dl.values()):
                problems.append(f"(b) hits: launches {dl}, want 0")
            # an answer injected in (a) was never cached: its key answers
            # its real answer now unless injected again
            recached = [i for k, i in enumerate(hit_idx)
                        if i in injected_a and k not in injected_b
                        and canon({"status": got[k]}) != want["set"][i]]
            if recached:
                problems.append(f"(b): {len(recached)} keys injected in (a) answer an "
                                f"injected answer from the cache")
            report("(b) hits c=1", wall, lat, n_hits, 1,
                   f"; {len(first)} keys injected in (a) among them; injected "
                   f"{list(counts_b)}; launches {json.dumps(dl)}")
            requests += [("b", "/v1/authorize", b, g, h, None)
                         for (b, _), g, h in zip(hit_items, got, hdrs)]
            injected_total = sum(c[0] for c in (counts, counts_c1, counts_b))

            # the headers: an id and a sampled traceparent on every
            # answer; a sent traceparent's id comes back
            for win, path, body, ans, h, sent in requests:
                rid = h.get("X-Cedar-Trace-Id", "")
                parsed = parse_traceparent(h.get("traceparent"))
                if len(rid) != 32 or parsed is None or parsed[0] != rid or \
                        not h["traceparent"].endswith("-01"):
                    problems.append(f"headers: {win} {path} answered {json.dumps(h)}")
                    break
                if sent and sent.split("-")[1] != rid:
                    problems.append(f"headers: sent {sent}, answered {rid}")
                    break

            # every request's trace, from /debug/traces/<id>
            conn = http.client.HTTPConnection("127.0.0.1", srv.mport, timeout=60)
            spans_of = {"a": [], "c1": [], "b": [], "adm": []}
            bad_trace = []
            try:
                for win, path, body, ans, h, sent in requests:
                    rid = h["X-Cedar-Trace-Id"]
                    conn.request("GET", f"/debug/traces/{rid}")
                    resp = conn.getresponse()
                    data = resp.read()
                    if resp.status != 200:
                        bad_trace.append(f"{win} {path} {rid}: HTTP {resp.status}")
                        continue
                    doc = json.loads(data)
                    names = [sp["name"] for sp in doc["spans"]]
                    label = adm_label(ans) if path == "/v1/admit" else sar_label(ans)
                    key = "adm" if path == "/v1/admit" else win
                    spans_of[key].append(doc)
                    if doc["decision"] != label or doc["traceId"] != rid:
                        bad_trace.append(f"{rid}: trace decision {doc['decision']}, answer {label}")
                    elif sent and doc["upstreamParent"] != sent.split("-")[2]:
                        bad_trace.append(f"{rid}: upstream parent {doc['upstreamParent']}")
                    elif path == "/v1/admit":
                        if doc["path"] != "admission":
                            bad_trace.append(f"{rid}: admission trace path {doc['path']}")
                    elif win == "b":
                        if names != ["authorization", "cache.lookup"]:
                            bad_trace.append(f"{rid}: hit spans {names}")
                    elif "cache.lookup" not in names or not (
                            {"batch.queue_wait", "batch.encode", "batch.dispatch",
                             "batch.decode"} <= set(names) or "coalesce.wait" in names):
                        bad_trace.append(f"{rid}: miss spans {names}")
            finally:
                conn.close()
            if bad_trace:
                problems.append(f"traces: {len(bad_trace)} bad, first {bad_trace[:3]}")
            for key, docs in spans_of.items():
                cov = [span_tree_coverage(d) for d in docs]
                if cov:
                    print(f"obs coverage {key}: {len(cov)} traces, min {min(cov):.4f}, p50 "
                          f"{pct(cov, 50):.4f}, p99 {pct(cov, 99):.4f}", flush=True)
            for key, what in (("c1", "a c=1 miss"), ("b", "a c=1 hit")):
                spans: dict = {}
                for d in spans_of[key]:
                    spans.setdefault("e2e (root)", []).append(d["duration_us"])
                    for sp in d["spans"][1:]:
                        spans.setdefault(sp["name"], []).append(sp["duration_us"])
                    spans.setdefault("not covered", []).append(
                        d["duration_us"] * (1 - span_tree_coverage(d)))
                print(f"obs spans of {what} ({card}), median us over {len(spans_of[key])}: "
                      + json.dumps({k: round(float(np.median(v)), 1) for k, v in spans.items()}),
                      flush=True)

            # the audit log: one line per answer, joined to the recorder
            with open(audit_log) as f:
                lines = [json.loads(ln) for ln in f]
            by_id = {}
            for ln in lines:
                by_id.setdefault(ln["traceId"], []).append(ln)
            recorded: dict = {}
            for name in os.listdir(rec_dir):
                _req, endpoint, fp, _ns = name.split("-")
                recorded.setdefault((endpoint, fp), []).append(os.path.join(rec_dir, name))
            bad_audit = []
            for win, path, body, ans, h, sent in requests:
                got_lines = by_id.get(h["X-Cedar-Trace-Id"], [])
                label = adm_label(ans) if path == "/v1/admit" else sar_label(ans)
                want_path = "admission" if path == "/v1/admit" else "authorization"
                if len(got_lines) != 1:
                    bad_audit.append(f"{len(got_lines)} lines for {h['X-Cedar-Trace-Id']}")
                    continue
                ln = got_lines[0]
                if (ln["path"], ln["decision"], ln["cached"]) != (want_path, label, win == "b"):
                    bad_audit.append(f"line {json.dumps(ln)} for a {win} {label} answer")
                    continue
                endpoint = "admit" if path == "/v1/admit" else "authorize"
                files = recorded.get((endpoint, ln["fingerprint"]), [])
                if not any(open(fn, "rb").read() == body for fn in files):
                    bad_audit.append(f"no recorder file holds the body of {ln['fingerprint']}")
            if len(lines) != len(requests) or bad_audit:
                problems.append(f"audit: {len(lines)} lines for {len(requests)} answers; "
                                f"{len(bad_audit)} bad, first {bad_audit[:3]}")
            n_files = sum(len(v) for v in recorded.values())
            print(f"obs audit: {len(lines)} lines for {len(requests)} answers, {n_files} "
                  f"recorder files, {len(bad_audit)} unjoined", flush=True)

            # the trace log, and cedar-trace over it
            with open(trace_log) as f:
                logged = [json.loads(ln)["traceId"] for ln in f]
            ids = {h["X-Cedar-Trace-Id"] for _w, _p, _b, _a, h, _t in requests}
            if len(logged) != len(requests) or set(logged) != ids:
                problems.append(f"trace log: {len(logged)} lines for {len(requests)} kept traces")
            chosen = spans_of["c1"][0]["traceId"]
            cli = subprocess.run([sys.executable, "-m", "cedar_tpu_torch.cli.trace", "--log",
                                  trace_log, chosen[:16]], capture_output=True, text=True,
                                 timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
            if cli.returncode != 0 or chosen not in cli.stdout:
                problems.append(f"cedar-trace: exit {cli.returncode}: {cli.stderr[-300:]}")
            print(f"obs cedar-trace --log {chosen[:16]}: exit {cli.returncode}; "
                  + " | ".join(cli.stdout.strip().splitlines()[-2:]), flush=True)

            # SLO: both paths, availability errors = the injected errors
            slo = json.loads(http_get(srv.mport, "/debug/slo")[1])
            text = http_get(srv.mport, "/metrics")[1].decode()
            adm_errors = sum(adm_label(w) == "<error>" for w in want_adm)
            for path_label, want_errors in (("authorization", injected_total),
                                            ("admission", adm_errors)):
                w = slo["paths"].get(path_label, {}).get("1h", {})
                if w.get("errors") != want_errors:
                    problems.append(f"slo {path_label}: {w.get('errors')} errors, want "
                                    f"{want_errors}")
                if f'cedar_slo_burn_rate{{path="{path_label}",slo="availability",window="5m"}}' \
                        not in text:
                    problems.append(f"no cedar_slo_burn_rate series for {path_label}")
            print(f"obs slo (1h window): " + json.dumps(
                {p: slo["paths"][p]["1h"] for p in slo["paths"]}), flush=True)
            problems += resilience_quiet("obs", text)
            fallback = metric_total(text, "cedar_authorizer_fallback_batches_total")
            if fallback:
                problems.append(f"{fallback:g} fallback batches")
            l_end = launches()
            launches_obs = {k: l_end[k] - l_start[k] for k in l_end}
            total_inj = injections(srv.mport)
            print(f"obs totals ({card}): injections {json.dumps(total_inj)}, launches "
                  f"{json.dumps(launches_obs)}", flush=True)
            if problems:
                fail("obs: " + "; ".join(problems))
            print(f"obs phase wall time ({card}): {time.monotonic() - t_phase:.1f} s",
                  flush=True)
            after = None
            if then is not None:
                after = then(srv, {
                    "sars": bodies, "want_sars": want["set"], "adm": adm,
                    "want_adm": want_adm, "audit_log": audit_log, "trace_log": trace_log,
                    "rec_dir": rec_dir, "fresh": distinct[n_keys + n_c1:],
                    "distinct": distinct, "api": api, "objects": base, "vfile": vfile,
                    "tmp": tmp,
                })
            took, rss = srv.terminate()
            print(f"obs webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()
            api.shutdown()
    return launches_obs, after


# phase 17: the SARs and reviews sent with ?explain=1, the first EXPLAIN_C1
# at concurrency 1, the rest at EXPLAIN_CONC (half of phase 15's first 512
# SARs and 256 reviews: the whole smoke passed 1,100 s of its 1,200 s with
# all of them)
EXPLAIN_SARS, EXPLAIN_REVIEWS, EXPLAIN_C1, EXPLAIN_CONC = 256, 128, 100, 8
# phase 17's serving window: bare misses on fresh keys at c=1, then at
# c=64, once alone and once beside an explain loop at EXPLAIN_CONC
BESIDE_C1, BESIDE_C64 = 16, 128
BESIDE_N = 2 * (BESIDE_C1 + BESIDE_C64)


def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of a process, all its threads."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def drive_explain(port: int, items: list, concurrency: int):
    """items: (path, body), each POSTed to path?explain=1 -> (wall s,
    [latency s], [whole answer document], [response headers], [client
    error]). Nothing is retried."""
    n = len(items)
    lat, docs, hdrs = [0.0] * n, [None] * n, [None] * n
    errors, next_i, lock = [], [0], threading.Lock()

    def worker():
        clients = {p: Client(port, p + "?explain=1", whole=True)
                   for p in ("/v1/authorize", "/v1/admit")}
        try:
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= n:
                    return
                path, body = items[i]
                docs[i], lat[i] = clients[path].post(body)
                hdrs[i] = clients[path].headers
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            for c in clients.values():
                c.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish within 600 s")
    return wall, lat, docs, hdrs, errors


def handler_error(path: str, want: dict) -> bool:
    """Whether the interpreter's answer for a body is the handler's error
    answer: NoOpinion with an evaluation error on /v1/authorize, an
    errored review (a code other than 200) on /v1/admit."""
    if path == "/v1/authorize":
        return bool(want.get("evaluationError")) and not (want["allowed"] or want["denied"])
    return adm_label(want) == "<error>"


def then_all(*steps):
    """One continuation for obs_phase running each of ``steps`` on its
    server in turn -> their results."""
    return lambda srv, ctx: [step(srv, ctx) for step in steps]


def explain_then(args, card: str, engine=None, split_bodies=None, corpus=None):
    """Phase 17 as the continuation obs_phase runs on its server. The
    split runs on ``engine`` (phase 4's) over ``split_bodies``, or, with
    ``corpus`` instead, on a fresh engine loaded with it."""
    def run(srv, ctx):
        out = explain_phase(args, card, srv, ctx)
        eng, bodies = engine, split_bodies
        if eng is None:
            from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine

            t0 = time.monotonic()
            eng = TorchPolicyEngine()
            eng.load(corpus.tiers())
            bodies = corpus.sar_bodies(60, seed=args.seed + 1)
            print(f"explain split: the corpus loaded in this process in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
        explain_split(card, eng, bodies)
        explain_threads(card, eng, bodies)
        return out
    return run


def _explain_state(srv, ctx) -> dict:
    """What an explain window must leave as it found it, and its counts."""
    text = http_get(srv.mport, "/metrics")[1].decode()
    explain = {}
    for line in text.splitlines():
        if line.startswith("cedar_explain_requests_total{"):
            explain[line.split('path="')[1].split('"')[0]] = float(line.rsplit(" ", 1)[1])
    eng = srv.debug_engine()
    cache = json.loads(http_get(srv.mport, "/debug/cache")[1])
    with open(ctx["audit_log"]) as f:
        audit = f.read()
    with open(ctx["trace_log"]) as f:
        n_trace_lines = sum(1 for _ in f)
    return {
        "cache": {p: {k: d[k] for k in ("hits", "misses", "size")} for p, d in cache.items()},
        "launches": {k: sum(eng[p]["engine"]["launches"][k] for p in ("authorization", "admission"))
                     for k in eng["authorization"]["engine"]["launches"]},
        "breakers": {p: eng[p]["breaker"] for p in ("authorization", "admission")},
        "injections": injections(srv.mport),
        "requests": metric_total(text, "cedar_authorizer_request_total"),
        "explain": explain,
        "compiles": metric_total(text, "cedar_explain_compiles_total"),
        "audit": audit,
        "trace_lines": n_trace_lines,
        "files": set(os.listdir(ctx["rec_dir"])),
    }


def explain_phase(args, card: str, srv, ctx: dict) -> dict:
    """Phase 17 (module docstring) on phase 15's server: ``ctx`` carries
    phase 15's bodies, their interpreter answers and the paths of its
    audit log, trace log and recorder directory. Returns the served
    launches of both kernels over the window ({name: delta}: 0)."""
    t_phase = time.monotonic()
    sars, adm = ctx["sars"][:EXPLAIN_SARS], ctx["adm"][:EXPLAIN_REVIEWS]
    items = [("/v1/authorize", b) for b in sars] + [("/v1/admit", b) for b in adm]
    expected = list(ctx["want_sars"][:EXPLAIN_SARS]) + list(ctx["want_adm"][:EXPLAIN_REVIEWS])
    rest = list(range(EXPLAIN_C1, len(items)))
    random.Random(args.seed + 17).shuffle(rest)
    order = list(range(EXPLAIN_C1)) + rest
    before = _explain_state(srv, ctx)
    cpu = [(proc_cpu_s(srv.proc.pid), time.process_time())]
    c1 = drive_explain(srv.port, [items[i] for i in order[:EXPLAIN_C1]], 1)
    cpu.append((proc_cpu_s(srv.proc.pid), time.process_time()))
    cn = drive_explain(srv.port, [items[i] for i in order[EXPLAIN_C1:]], EXPLAIN_CONC)
    cpu.append((proc_cpu_s(srv.proc.pid), time.process_time()))
    after = _explain_state(srv, ctx)
    if c1[4] or cn[4]:
        fail(f"explain: client errors {(c1[4] + cn[4])[:3]}")
    docs, hdrs = c1[2] + cn[2], c1[3] + cn[3]
    problems = []
    flips, not_device, bad_det, injected, gates = [], [], [], [], {}
    for k, i in enumerate(order):
        path, doc, want = items[i][0], docs[k], expected[i]
        expl = doc.get("explanation")
        if expl is None:
            problems.append(f"an explain answer without an explanation: {json.dumps(doc)[:300]}")
            break
        if path == "/v1/authorize":
            st = doc["status"]
            if st in (INJECTED_ERROR, INJECTED_DENY):
                injected.append(i)
            if canon({"status": st}) != want:
                flips.append((i, want, st))
            # an allow or a deny names its policies in the reason
            ids = [json.loads(r)["policy"] for r in want["reason"]] if want["reason"] else []
            permit = None
            decided = st["allowed"] or st["denied"]
        else:
            resp = doc["response"]
            if adm_key(resp) != adm_key(want):
                flips.append((i, want, resp))
            # a deny names its policies in the message; an allowed review
            # names none, and a permit decided it
            msg = resp["status"]["message"]
            ids = [r["policy"] for r in json.loads(msg)] if msg.startswith("[{") else []
            permit = bool(resp["allowed"])
            decided = permit or bool(ids)
        src = expl["source"]
        if src == "gate":
            label = expl.get("shortCircuit")
            gates[label] = gates.get(label, 0) + 1
            if label == "explain-error" and not handler_error(path, want):
                # only a body the bare handler also answers with its error
                # may explain as one: any other is a failed device explain
                not_device.append((i, label))
            continue
        if src != "device":
            not_device.append((i, src))
            continue
        det = expl.get("determining")
        if decided and (det is None or (det["effect"] != "permit" if permit
                                        else det["policyId"] not in ids)):
            bad_det.append((i, det and det["policyId"], ids))
    for i, w, g in flips[:3]:
        print(f"explain flip: {items[i][0]} expected {json.dumps(w)}, got {json.dumps(g)}",
              flush=True)
    if flips:
        problems.append(f"{len(flips)} flips against the interpreter")
    if not_device:
        problems.append(f"{len(not_device)} answers not from the device with the breakers "
                        f"closed, first {not_device[:3]}")
    if bad_det:
        problems.append(f"{len(bad_det)} determining policies outside the interpreter's "
                        f"reasons, first {bad_det[:3]}")
    if injected:
        problems.append(f"{len(injected)} explain answers carry the injector's answer")
    for key in ("cache", "launches", "injections", "requests", "trace_lines"):
        if after[key] != before[key]:
            problems.append(f"{key} moved across the window: {before[key]} -> {after[key]}")
    if set(after["breakers"].values()) != {"closed"}:
        problems.append(f"breakers {after['breakers']}")
    ids = [h["X-Cedar-Trace-Id"] for h in hdrs]
    if after["audit"] != before["audit"] or any(rid in after["audit"] for rid in ids):
        problems.append("the audit log changed in the explain window")
    conn = http.client.HTTPConnection("127.0.0.1", srv.mport, timeout=60)
    kept = []
    try:
        for rid in ids:
            conn.request("GET", f"/debug/traces/{rid}")
            resp = conn.getresponse()
            resp.read()
            if resp.status != 404:
                kept.append(rid)
    finally:
        conn.close()
    if kept:
        problems.append(f"{len(kept)} explain requests have a kept trace, first {kept[:2]}")
    new = sorted(after["files"] - before["files"])
    recorded = []
    for name in new:
        with open(os.path.join(ctx["rec_dir"], name), "rb") as f:
            recorded.append(f.read())
    if sorted(recorded) != sorted(b for _p, b in items):
        problems.append(f"{len(new)} new recorder files for {len(items)} explain bodies, "
                        "not one per body")
    sent = {"authorization": len(sars), "admission": len(adm)}
    got = {p: after["explain"].get(p, 0.0) - before["explain"].get(p, 0.0) for p in sent}
    if got != sent:
        problems.append(f"cedar_explain_requests_total moved {got}, {sent} sent")
    if after["compiles"]:
        problems.append(f"cedar_explain_compiles_total is {after['compiles']:g}, want 0")
    launches = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
    for k, (label, (wall, lat, *_x)) in enumerate((("c=1", c1), (f"c={EXPLAIN_CONC}", cn))):
        srv_cpu, own_cpu = (cpu[k + 1][j] - cpu[k][j] for j in (0, 1))
        print(f"explain {label} ({card}): {len(lat)} requests, {len(lat) / wall:.1f} requests/s, "
              f"p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms; server CPU "
              f"{srv_cpu / len(lat) * 1e3:.3f} ms per request ({srv_cpu / wall:.2f} cores busy), "
              f"client CPU {own_cpu / len(lat) * 1e3:.3f} ms per request", flush=True)
    print(f"explain answers: {len(items)} ({len(sars)} SARs, {len(adm)} reviews), flips "
          f"{len(flips)}, gates {json.dumps(gates)}, new recorder files {len(new)}, explain "
          f"requests {json.dumps(got)}, compiles {after['compiles']:g}, launches "
          f"{json.dumps(launches)}, cache {json.dumps(after['cache'])}", flush=True)
    if problems:
        fail("explain: " + "; ".join(problems))
    explain_beside_serving(card, srv, ctx["fresh"], items)
    print(f"explain phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return {"launches": launches}


def explain_beside_serving(card: str, srv, fresh: list, items: list) -> None:
    """Whether an operator's explain session slows serving: bare SARs on
    keys the cache never saw (misses: the device path) at c=1, then at
    c=64, once alone and once beside an explain loop over ``items`` at
    EXPLAIN_CONC, each window on its own fresh bodies. Prints serving
    p50 / p99 in both and the explain rate beside; a client error fails.
    The injector stays on: a few answers are its own."""
    per = BESIDE_C1 + BESIDE_C64
    rows = []
    for k, beside in enumerate((False, True)):
        part = fresh[k * per:(k + 1) * per]
        stop, done, errors = threading.Event(), [0] * EXPLAIN_CONC, []

        def loop(j):
            clients = {p: Client(srv.port, p + "?explain=1", whole=True)
                       for p in ("/v1/authorize", "/v1/admit")}
            try:
                i = j
                while not stop.is_set():
                    path, body = items[i % len(items)]
                    clients[path].post(body)
                    done[j] += 1
                    i += EXPLAIN_CONC
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            finally:
                for c in clients.values():
                    c.close()

        threads = [threading.Thread(target=loop, args=(j,))
                   for j in range(EXPLAIN_CONC if beside else 0)]
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        w1 = drive(srv.port, part[:BESIDE_C1], 1)
        w64 = drive(srv.port, part[BESIDE_C1:], 64)
        wall = time.perf_counter() - t0
        stop.set()
        for th in threads:
            th.join(timeout=120)
        if w1[3] or w64[3] or errors or any(th.is_alive() for th in threads):
            fail(f"explain beside serving: client errors {(w1[3] + w64[3] + errors)[:3]}")
        rows.append((beside, w1, w64, sum(done) / wall))
    for beside, w1, w64, rate in rows:
        what = (f"beside explain at c={EXPLAIN_CONC} ({rate:.1f} explain requests/s)"
                if beside else "alone")
        print(f"serving {what} ({card}): misses at c=1 p50 {pct(w1[1], 50) * 1e3:.3f} ms, "
              f"p99 {pct(w1[1], 99) * 1e3:.3f} ms; at c=64 {len(w64[1]) / w64[0]:.1f} "
              f"requests/s, p50 {pct(w64[1], 50) * 1e3:.3f} ms, p99 "
              f"{pct(w64[1], 99) * 1e3:.3f} ms", flush=True)


def explain_threads(card: str, engine, bodies: list, n: int = 64) -> None:
    """Explain at concurrency in this process, with no HTTP layer: ``n``
    explain_authorize calls (and the answer's json.dumps) on an Explainer
    over ``engine``, from 1 thread, from EXPLAIN_CONC threads, from
    EXPLAIN_CONC threads with the interpreter's switch interval cut from
    5 ms to 0.5 ms, with one explain at a time (a lock around each call)
    and with one bits fetch at a time (a lock around the fetch, its wait
    counted in the fetch). Prints for each the requests/s, this process's CPU
    per request and the host time per request in encode, the bits fetch
    and build_explanation (summed over threads); then one more burst at
    EXPLAIN_CONC under torch.profiler: the CUDA runtime calls' host time
    per request and the card's busy share of the burst."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cedar_tpu_torch.explain import explainer as ex_mod
    from cedar_tpu_torch.explain.plane import ExplainPlane

    exp = ex_mod.Explainer(authz_engine=engine)
    spent, lock = {}, threading.Lock()

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
        return wrapper

    orig = (ex_mod.encode_single, ExplainPlane.explain_row, ex_mod.build_explanation)
    serial, one_fetch = threading.Lock(), [False]

    def bits_fetch(*a, **kw):
        if not one_fetch[0]:
            return orig[1](*a, **kw)
        with serial:
            return orig[1](*a, **kw)

    def burst(threads: int, one_explain: bool = False) -> dict:
        spent.clear()
        next_i = [0]

        def explain(body):
            return json.dumps(exp.explain_authorize(body)[3])

        def worker():
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= n:
                    return
                if one_explain:
                    with serial:
                        explain(bodies[i % len(bodies)])
                else:
                    explain(bodies[i % len(bodies)])

        ths = [threading.Thread(target=worker) for _ in range(threads)]
        c0, t0 = time.process_time(), time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        wall, cpu_s = time.perf_counter() - t0, time.process_time() - c0
        return {"requests/s": round(n / wall, 1), "cpu ms/request": round(cpu_s / n * 1e3, 3),
                "wall s": wall,
                **{f"{k} ms/request": round(spent.get(k, 0.0) / n * 1e3, 3)
                   for k in ("encode", "bits", "build")}}

    ex_mod.encode_single = timed("encode", orig[0])
    ExplainPlane.explain_row = timed("bits", bits_fetch)
    ex_mod.build_explanation = timed("build", orig[2])
    switch = sys.getswitchinterval()
    try:
        for body in bodies[:10]:
            exp.explain_authorize(body)
        rows = {"1 thread": burst(1), f"{EXPLAIN_CONC} threads": burst(EXPLAIN_CONC)}
        sys.setswitchinterval(0.0005)
        rows[f"{EXPLAIN_CONC} threads, switch 0.5 ms"] = burst(EXPLAIN_CONC)
        sys.setswitchinterval(switch)
        rows[f"{EXPLAIN_CONC} threads, one explain at a time"] = burst(EXPLAIN_CONC, True)
        one_fetch[0] = True
        rows[f"{EXPLAIN_CONC} threads, one bits fetch at a time"] = burst(EXPLAIN_CONC)
        one_fetch[0] = False
        try:  # every thread's ops, where this torch can
            from torch._C._profiler import _ExperimentalConfig

            extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):
            extra = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **extra) as prof:
            row = burst(EXPLAIN_CONC)
    finally:
        sys.setswitchinterval(switch)
        ex_mod.encode_single, ExplainPlane.explain_row, ex_mod.build_explanation = orig
    for label, r in rows.items():
        r.pop("wall s")
        print(f"explain in-process, {label} ({card}): {json.dumps(r)}", flush=True)
    events, device_us = prof.key_averages(), 0.0
    for ev in events:
        dev = getattr(ev, "self_device_time_total", None)
        device_us += dev if dev is not None else getattr(ev, "self_cuda_time_total", 0.0)

    def top(prefix: str, k: int) -> dict:
        # {name: [calls per request, host ms per request]}, by host time
        evs = sorted((ev for ev in events if ev.key.startswith(prefix)),
                     key=lambda ev: -ev.cpu_time_total)[:k]
        return {ev.key: [round(ev.count / n, 2), round(ev.cpu_time_total / 1e3 / n, 4)]
                for ev in evs}

    print(f"explain in-process profile, {EXPLAIN_CONC} threads ({card}): {row['requests/s']} "
          f"requests/s, card busy {device_us / 1e6 / row['wall s']:.4f} of the burst; "
          f"[calls, host ms] per request: aten {json.dumps(top('aten::', 6))}, CUDA runtime "
          f"{json.dumps(top('cuda', 4))}", flush=True)


def explain_split(card: str, engine, bodies: list, reps: int = 50) -> None:
    """One c=1 explain request split in this process on ``engine``:
    encode (the Python encoder into the engine's arrays), the bits fetch
    (CUDA events around ExplainPlane.explain_row, which also returns its
    host time) and build_explanation with its bitset decode; medians
    over ``reps`` requests after 10 warm ones."""
    import torch

    from cedar_tpu_torch.explain.attribution import build_explanation, sat_from_bits
    from cedar_tpu_torch.explain.plane import ExplainPlane, encode_single
    from cedar_tpu_torch.server.authorizer import record_to_cedar_resource
    from cedar_tpu_torch.server.sar import get_authorizer_attributes

    cs = engine.compiled_set
    plane = ExplainPlane(engine)
    split = {"encode": [], "bits (device)": [], "bits (host)": [], "build_explanation": []}
    sources = set()
    for k in range(reps + 10):
        body = bodies[k % len(bodies)]
        ent, req = record_to_cedar_resource(get_authorizer_attributes(json.loads(body)))
        t0 = time.perf_counter()
        codes, extras = encode_single(engine, cs, ent, req)
        t1 = time.perf_counter()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        bits = plane.explain_row(codes, extras, cs=cs)
        e1.record()
        t2 = time.perf_counter()
        sat = sat_from_bits(cs.packed, bits[0])
        _d, _diag, expl = build_explanation(cs.packed, sat, ent, req, source="device")
        t3 = time.perf_counter()
        e1.synchronize()
        sources.add(expl["source"])
        if k >= 10:
            split["encode"].append((t1 - t0) * 1e3)
            split["bits (device)"].append(e0.elapsed_time(e1))
            split["bits (host)"].append((t2 - t1) * 1e3)
            split["build_explanation"].append((t3 - t2) * 1e3)
    print(f"explain split of a c=1 request ({card}), median ms over {reps} on L={cs.L} "
          f"R={cs.R}: " + json.dumps({k: round(float(np.median(v)), 4) for k, v in split.items()}),
          flush=True)
    if sources != {"device"}:
        fail(f"explain split: sources {sources}")


# phase 18: the SARs and reviews of the shadow window, sent in chunks
# (each drained before the next, so the 1,024-deep shadow queue never
# fills and every offer is evaluated); the windows after each swap; under
# --only-rollout, the misses (fresh keys) of each of the four live-cost
# windows at c=1 and at c=64 (alone, beside the shadow at its default
# duty cycle, beside it again, alone again)
ROLLOUT_CHUNKS, ROLLOUT_CHUNK_SARS, ROLLOUT_CHUNK_REVIEWS = 2, 96, 24
ROLLOUT_SWAP_SARS, ROLLOUT_SWAP_REVIEWS = 192, 48
ROLLOUT_C1, ROLLOUT_C64 = 400, 2000
ROLLOUT_COST_WINDOWS = ("alone", "beside", "beside", "alone")
# the candidate: phase 12's objects as candidate-labelled copies named
# cand-<name>, every permit of the first ROLLOUT_FLIPPED synth objects
# turned forbid, the interpreter-fallback policies left out (the strict
# stage gate refuses them) and one object added (phase 10's flip file)
ROLLOUT_FLIPPED = 20
ROLLOUT_TOKEN = "phase-18-rollout-token"
CANDIDATE_LABEL = {"cedar.k8s.aws/rollout": "candidate"}


def candidate_objects(base: dict) -> dict:
    """Phase 18's candidate objects {name: content} from phase 12's."""
    out = {}
    for k, (name, content) in enumerate(sorted(base.items())):
        if name == "gated":
            content = NATIVE_OPAQUE_POLICY
        elif name == "admission":
            content = ADM_POLICIES + ADM_DEMO_OWNER_POLICY
        elif k < ROLLOUT_FLIPPED:
            content = content.replace("permit (", "forbid (")
        out[f"cand-{name}"] = content
    out["cand-added"] = RELOAD_FLIP_POLICY
    return out


def _decision_of(status: dict) -> str:
    return "allow" if status["allowed"] else "deny" if status["denied"] else "no_opinion"


def diff_class(live, cand, path: str):
    """The shadow diff kind the interpreter's live and candidate answers
    give (rollout/report.py classify_decision_diff over decisions and
    reason sets; live and candidate policy ids always differ, so two
    reason sets are equal only when both are empty), or "skipped" for an
    admission answer the shadow worker does not diff (code other than
    200)."""
    from cedar_tpu_torch.rollout.report import classify_decision_diff

    if path == "/v1/admit":
        if adm_label(live) == "<error>":
            return "skipped"
        a, b = adm_key(live), adm_key(cand)
        return classify_decision_diff("allow" if a[1] else "deny", json.dumps(a[3]),
                                      "allow" if b[1] else "deny", json.dumps(b[3]))
    return classify_decision_diff(_decision_of(live), json.dumps(live["reason"]),
                                  _decision_of(cand), json.dumps(cand["reason"]))


def rollout_then(args, card: str, corpus):
    """Phase 18 as the continuation obs_phase runs on its server (after
    phase 17 in a whole run): a fresh SAR pool from ``corpus``, larger
    under --only-rollout, whose live-cost windows take 9,600 misses."""
    def run(srv, ctx):
        n = 16384 if args.only_rollout else 8192
        return rollout_phase(args, card, srv, ctx, gated_bodies(corpus, n, seed=args.seed + 18))
    return run


def rollout_phase(args, card: str, srv, ctx: dict, pool: list) -> dict:
    """Phase 18 (module docstring) on phase 15's server, started with
    --rollout-control-token-file. ``ctx`` carries phase 15's fake
    apiserver, its objects and their file, its keys and its directory.
    Returns the phase's launches of both kernels: the server's served
    ones and the shadow worker's on the candidate engines."""
    from cedar_tpu_torch.cache import fingerprint_body
    from cedar_tpu_torch.lang.parser import parse_policies

    t_phase = time.monotonic()
    problems = []
    api, tmp = ctx["api"], ctx["tmp"]
    bearer = {"Authorization": f"Bearer {ROLLOUT_TOKEN}"}

    def post(path, doc=None, headers=None, timeout=600):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.mport}{path}", method="POST",
                                     data=json.dumps(doc or {}).encode(),
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                code, data = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, data = e.code, e.read()
        return code, json.loads(data), time.perf_counter() - t

    def status():
        return json.loads(http_get(srv.mport, "/debug/rollout")[1])

    def engine_state():
        doc = srv.debug_engine()
        return {p: {"launches": doc[p]["engine"]["launches"],
                    "warmup": doc[p]["engine"]["warmup_launches"],
                    "encoder_builds": doc[p]["encoder_builds"],
                    "generation": doc[p]["engine"]["load_generation"]}
                for p in ("authorization", "admission")}

    # ---- the traffic: keys phases 15 and 17 never sent (misses)
    seen = {fingerprint_body("authorize", b) for b in ctx["distinct"]}
    fresh = []
    for b in pool:
        key = fingerprint_body("authorize", b)
        if key is not None and key not in seen:
            seen.add(key)
            fresh.append(b)
    # the live cost of the shadow is measured under --only-rollout alone:
    # its windows take minutes a whole run has not got
    cost = args.only_rollout
    n_shadow = ROLLOUT_CHUNKS * ROLLOUT_CHUNK_SARS
    n_probe = len(ROLLOUT_COST_WINDOWS) * (ROLLOUT_C1 + ROLLOUT_C64) if cost else 0
    shadow_sars = fresh[:n_shadow]
    probe = fresh[n_shadow:n_shadow + n_probe]
    if len(probe) < n_probe:
        fail(f"rollout: only {len(fresh)} fresh keys in a pool of {len(pool)}")
    reviews = admission_bodies(ROLLOUT_CHUNKS * ROLLOUT_CHUNK_REVIEWS, args.seed + 18)
    swap_sars, swap_reviews = shadow_sars[:ROLLOUT_SWAP_SARS], reviews[:ROLLOUT_SWAP_REVIEWS]

    # ---- the candidate objects and the oracle over both corpora
    cand = candidate_objects(ctx["objects"])
    cfile = os.path.join(tmp, "candidate.json")
    with open(cfile, "w") as f:
        json.dump([{"metadata": {"name": n, "uid": f"uid-{n}", "labels": CANDIDATE_LABEL},
                    "spec": {"content": c}} for n, c in cand.items()], f)
    n_cand = sum(len(parse_policies(c, n)) for n, c in cand.items())
    oracle_out = {}

    def oracle():
        t0 = time.monotonic()
        oracle_out.update(interpreter_answers(
            {"live": (f"crd-authorize:{ctx['vfile']}", shadow_sars),
             "cand": (f"cand-authorize:{cfile}", shadow_sars),
             "live_adm": (f"crd-admit:{ctx['vfile']}", reviews),
             "cand_adm": (f"cand-admit:{cfile}", reviews)},
            args.policies, args.seed, piece=256))
        oracle_out["seconds"] = time.monotonic() - t0

    oracle_thread = threading.Thread(target=oracle)

    # ---- 1. control refusals (the server has a token)
    for label, headers, want in (("no token", None, 403), ("wrong token",
                                 {"Authorization": "Bearer nope"}, 403),
                                 ("token, idle", bearer, 409)):
        code, body, _ = post("/rollout/promote", headers=headers)
        if code != want:
            problems.append(f"promote with {label}: {code} {body}, want {want}")
    if status()["state"] != "idle":
        problems.append(f"rollout state before staging: {status()['state']}")
    inj0, e0 = injections(srv.mport), engine_state()

    # ---- 2. the first live-cost window: no candidate staged (and the
    # oracle pool not started: it would take the host's cores)
    cost_runs = []  # (condition, c=1 drive, c=64 drive, bodies), in order

    def cost_window(condition):
        k = len(cost_runs) * (ROLLOUT_C1 + ROLLOUT_C64)
        b1, b64 = probe[k:k + ROLLOUT_C1], probe[k + ROLLOUT_C1:k + ROLLOUT_C1 + ROLLOUT_C64]
        w1, w64 = drive(srv.port, b1, 1), drive(srv.port, b64, 64)
        if w1[3] or w64[3]:
            fail(f"rollout live-cost window: client errors {(w1[3] + w64[3])[:3]}")
        cost_runs.append((condition, w1, w64, b1 + b64))
        print(f"rollout live serving, window {len(cost_runs)} {condition} ({card}): misses at "
              f"c=1 p50 {pct(w1[1], 50) * 1e3:.3f} ms, p99 {pct(w1[1], 99) * 1e3:.3f} ms over "
              f"{w1[0]:.3f} s; at c=64 {len(b64) / w64[0]:.1f} requests/s over {w64[0]:.3f} s, "
              f"p99 {pct(w64[1], 99) * 1e3:.3f} ms", flush=True)

    if cost:
        cost_window(ROLLOUT_COST_WINDOWS[0])
    oracle_thread.start()

    # ---- 3. stage the CRD candidate
    for name, content in cand.items():
        api.apply(name, content, labels=CANDIDATE_LABEL)
    time.sleep(3.0)  # the store withholds them from live serving

    def stage_candidate(label):
        code, doc, stage_s = post("/rollout/stage", {"crd": True}, bearer)
        if code != 200 or doc.get("state") != "staged":
            fail(f"{label}: {code} {json.dumps(doc)[:600]}")
        if doc["candidate"]["policies"] != n_cand:
            fail(f"{label}: {doc['candidate']['policies']} candidate policies, want {n_cand} "
                 "(the store had not seen every candidate object)")
        t_ready = time.monotonic()
        while True:
            st = status()
            if st["candidate"]["warm_state"] == "ready":
                break
            if st["candidate"]["warm_state"] == "failed" or time.monotonic() - t_ready > 300:
                fail(f"{label}: candidate warm-up {st['candidate']['warm_state']}")
            time.sleep(0.1)
        ready_s = stage_s + time.monotonic() - t_ready
        warm = st["candidate"]["warm_stats"]
        print(f"{label} ({card}): {n_cand} candidate policies; POST /rollout/stage "
              f"{stage_s:.3f} s (the gate and both candidate compiles), stage to ready "
              f"{ready_s:.3f} s; per engine " + json.dumps(
                  {e: {"compile_seconds": w["compile_seconds"], "warm_seconds": w["seconds"],
                       "buckets": w["buckets"], "warmup_launches": w["launches"]}
                   for e, w in warm.items()}), flush=True)
        for e, w in warm.items():
            if not all(w["launches"].values()):
                problems.append(f"candidate {e} warm-up launched {w['launches']}")
        return st

    st = stage_candidate("rollout stage")
    injected = {"error": 0, "deny": 0}
    pending = []  # windows sent before the oracle finished: checked after
    ans: dict = {}

    def join_oracle():
        if ans:
            return
        oracle_thread.join(timeout=900)
        if "live" not in oracle_out:
            fail("rollout: the oracle pool did not finish")
        print(f"rollout oracle: {2 * len(shadow_sars) + 2 * len(reviews)} "
              f"interpreter answers in {oracle_out['seconds']:.1f} s", flush=True)
        ans.update(
            live_sar=dict(zip(shadow_sars, oracle_out["live"])),
            cand_sar=dict(zip(shadow_sars, oracle_out["cand"])),
            live_adm=[a["response"] for a in oracle_out["live_adm"]],
            cand_adm=[a["response"] for a in oracle_out["cand_adm"]])

    def check(label, sars, got, want_of, adm=(), got_adm=(), want_adm=()):
        """Every answer the oracle's (an injected SAR answer apart, counted);
        the flips are reported into problems."""
        flips = 0
        for b, g in zip(sars, got):
            if g == INJECTED_ERROR:
                injected["error"] += 1
            elif g == INJECTED_DENY:
                injected["deny"] += 1
            elif canon({"status": g}) != want_of[b]:
                flips += 1
                if flips <= 3:
                    print(f"rollout {label} flip: expected {json.dumps(want_of[b])}, got "
                          f"{json.dumps(g)}", flush=True)
        flips += sum(adm_key(g) != adm_key(w) for g, w in zip(got_adm, want_adm))
        if flips:
            problems.append(f"{label}: {flips} flips")
        return flips

    def window(label, sars, revs, want, c_sar=12, c_adm=4):
        """SARs at c_sar beside reviews at c_adm; checked against the
        oracle's ``want`` (live_sar / cand_sar, live_adm / cand_adm and
        the reviews' offset) now, or, before the oracle finished, later."""
        out = {}
        th = threading.Thread(target=lambda: out.update(
            adm=drive(srv.port, revs, c_adm, "/v1/admit")))
        th.start()
        wall, lat, got, errors = drive(srv.port, sars, c_sar)
        th.join(timeout=600)
        a_wall, a_lat, a_got, a_errors = out["adm"]
        if errors or a_errors:
            fail(f"rollout {label}: client errors {(errors + a_errors)[:3]}")
        print(f"rollout {label} ({card}): {len(sars)} SARs at c={c_sar} {len(sars) / wall:.1f} "
              f"requests/s, p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms; "
              f"{len(revs)} reviews at c={c_adm} p99 {pct(a_lat, 99) * 1e3:.3f} ms", flush=True)
        pending.append((label, sars, got, want, revs, a_got))
        if ans:
            check_pending()

    def check_pending():
        while pending:
            label, sars, got, (sar_key, adm_key_, lo), revs, a_got = pending.pop(0)
            want_adm = ans[adm_key_][lo:lo + len(revs)] if revs else []
            flips = check(label, sars, got, ans[sar_key], revs, a_got, want_adm)
            print(f"rollout {label}: flips {flips}", flush=True)

    offered = 0

    def drained(offered_n):
        deadline = time.monotonic() + 300
        while True:
            st = status()
            d = st["diff"]
            seen_n = (sum(d["evaluations"].values()) + sum(d["shed"].values())
                      + sum(d["skipped"].values()))
            if st["shadow_queue"] == 0 and seen_n == offered_n:
                return st
            if time.monotonic() > deadline:
                fail(f"rollout: the shadow worker did not drain ({seen_n} of {offered_n} "
                     f"offers accounted for)")
            time.sleep(0.1)

    # ---- 4. the shadow window: every evaluated body's class the oracle's
    t_shadow = time.monotonic()
    for k in range(ROLLOUT_CHUNKS):
        s_part = shadow_sars[k * ROLLOUT_CHUNK_SARS:(k + 1) * ROLLOUT_CHUNK_SARS]
        r_part = reviews[k * ROLLOUT_CHUNK_REVIEWS:(k + 1) * ROLLOUT_CHUNK_REVIEWS]
        window(f"shadow chunk {k}", s_part, r_part,
               ("live_sar", "live_adm", k * ROLLOUT_CHUNK_REVIEWS))
        offered += len(s_part) + len(r_part)
        st = drained(offered)
    shadow_wall = time.monotonic() - t_shadow
    join_oracle()
    check_pending()
    live_sar, cand_sar = ans["live_sar"], ans["cand_sar"]
    live_adm, cand_adm = ans["live_adm"], ans["cand_adm"]
    n_rev = ROLLOUT_CHUNKS * ROLLOUT_CHUNK_REVIEWS
    want_kinds: dict = {}
    fp_kind = {}
    for b in shadow_sars:
        kind = diff_class(live_sar[b], cand_sar[b], "/v1/authorize")
        fp_kind[fingerprint_body("authorize", b)] = kind
        want_kinds[kind] = want_kinds.get(kind, 0) + 1
    for b, lv, cv in zip(reviews[:n_rev], live_adm, cand_adm):
        kind = diff_class(lv, cv, "/v1/admit")
        fp = fingerprint_body("admit", b)
        if fp is not None:
            fp_kind[fp] = kind
        want_kinds[kind] = want_kinds.get(kind, 0) + 1
    d = st["diff"]
    got_kinds = {k: n for k, n in d["diffs"].items() if n}
    n_match = sum(d["matches"].values())
    if d["matches"]:
        got_kinds[None] = n_match
    if d["skipped"]:
        got_kinds["skipped"] = sum(d["skipped"].values())
    want_cmp = {k: n for k, n in want_kinds.items() if n}
    bad_ex = [e for e in d["exemplars"] if fp_kind.get(e["fingerprint"]) != e["kind"]]
    print(f"rollout shadow window ({card}): {offered} offers in {shadow_wall:.3f} s, "
          f"evaluations {json.dumps(d['evaluations'])}, diffs {json.dumps(d['diffs'])}, "
          f"matches {n_match}, skipped {json.dumps(d['skipped'])}, shed "
          f"{json.dumps(d['shed'])}, candidate errors {d['candidate_errors']}; the oracle's "
          f"classes {json.dumps({str(k): n for k, n in want_cmp.items()})}; shadow launches "
          f"{json.dumps(st['shadow_launches'])}", flush=True)
    if d["shed"]:
        problems.append(f"shadow window shed {d['shed']}: it is paced not to")
    if got_kinds != want_cmp:
        problems.append(f"shadow classes {got_kinds} unlike the oracle's {want_cmp}")
    if bad_ex or not d["exemplars"]:
        problems.append(f"{len(bad_ex)} of {len(d['exemplars'])} exemplars unlike the oracle")
    if d["candidate_errors"]:
        problems.append(f"{d['candidate_errors']} candidate errors")
    if not st["shadow_launches"]["match_words_kernel"]:
        problems.append(f"the candidate engines launched {st['shadow_launches']}")

    # ---- 5. the live cost of the shadow (--only-rollout): two windows
    # beside it, then every offer accounted for once the worker drained
    # (at c=64 the queue fills, so offers shed); the candidate discarded
    # (rollback while staged), the last window alone, and the candidate
    # staged again for the swaps
    shadow_launches = {k: 0 for k in st["shadow_launches"]}

    def add_shadow_launches():
        """Count the current candidate's shadow launches into the phase's."""
        for k, n in status().get("shadow_launches", {}).items():
            shadow_launches[k] += n

    if cost:
        for condition in ROLLOUT_COST_WINDOWS[1:3]:
            cost_window(condition)
        offered += sum(len(run[3]) for run in cost_runs[1:3])
        st = drained(offered)
        print(f"rollout shadow after the windows beside it: shed {json.dumps(st['diff']['shed'])}, "
              f"evaluations {json.dumps(st['diff']['evaluations'])}, offered {offered}", flush=True)
        add_shadow_launches()
        code, doc, discard_s = post("/rollout/rollback", headers=bearer)
        if code != 200 or doc.get("state") != "idle" or "candidate" in doc:
            fail(f"rollout discard: {code} {json.dumps(doc)[:600]}")
        print(f"rollout discard of the staged candidate ({card}): POST /rollout/rollback "
              f"{discard_s * 1e3:.3f} ms", flush=True)
        for condition in ROLLOUT_COST_WINDOWS[3:]:
            cost_window(condition)
        stage_candidate("rollout restage")
    else:
        print("rollout live cost of the shadow: not measured in this run (chip_smoke.py "
              "--only-rollout measures it)", flush=True)
    add_shadow_launches()

    # ---- 6. promote: the candidate serves, warmed, its encoder built
    e1 = engine_state()
    code, doc, promote_s = post("/rollout/promote", headers=bearer)
    if code != 200 or doc.get("state") != "promoted":
        fail(f"rollout promote: {code} {json.dumps(doc)[:600]}")
    first = Client(srv.port)
    g, first_promote = first.post(swap_sars[-1])
    check("first answer after promote", [swap_sars[-1]], [g], cand_sar)
    e2 = engine_state()
    window("after promote", swap_sars, swap_reviews, ("cand_sar", "cand_adm", 0), c_sar=16)
    e3 = engine_state()
    for p in e1:
        if e2[p]["encoder_builds"] != e1[p]["encoder_builds"] + 1:
            problems.append(f"{p}: promote built {e2[p]['encoder_builds'] - e1[p]['encoder_builds']}"
                            " native encoders, want 1 (at adoption)")
        if e3[p]["encoder_builds"] != e2[p]["encoder_builds"]:
            problems.append(f"{p}: the window after promote built an encoder")
        if e3[p]["warmup"] != e1[p]["warmup"]:
            problems.append(f"{p}: warm-up launches after promote {e1[p]['warmup']} -> "
                            f"{e3[p]['warmup']}")
        if e2[p]["generation"] != e1[p]["generation"] + 1:
            problems.append(f"{p}: promote stepped the generation {e1[p]['generation']} -> "
                            f"{e2[p]['generation']}")

    # ---- 7. roll back: the pre-promotion sets serve again
    code, doc, rollback_s = post("/rollout/rollback", headers=bearer)
    if code != 200 or doc.get("state") != "idle":
        fail(f"rollout rollback: {code} {json.dumps(doc)[:600]}")
    g, first_rollback = first.post(swap_sars[-2])
    first.close()
    check("first answer after rollback", [swap_sars[-2]], [g], live_sar)
    window("after rollback", swap_sars, swap_reviews, ("live_sar", "live_adm", 0), c_sar=16)
    e4 = engine_state()
    for p in e1:
        if e4[p]["encoder_builds"] != e3[p]["encoder_builds"] or e4[p]["warmup"] != e1[p]["warmup"]:
            problems.append(f"{p}: rollback built an encoder or warmed: {e3[p]} -> {e4[p]}")
    print(f"rollout swaps ({card}): POST /rollout/promote {promote_s * 1e3:.3f} ms, first "
          f"answer after it {first_promote * 1e3:.3f} ms; POST /rollout/rollback "
          f"{rollback_s * 1e3:.3f} ms, first answer after it {first_rollback * 1e3:.3f} ms; "
          f"encoder builds {json.dumps({p: e4[p]['encoder_builds'] for p in e4})}", flush=True)

    # ---- 8. the live-cost windows' answers against the oracle (after
    # every window, so its pool never took the host's cores beside one),
    # their medians, and the phase's totals
    if cost:
        t0 = time.monotonic()
        ans["probe_sar"] = dict(zip(probe, interpreter_answers(
            {"probe": (f"crd-authorize:{ctx['vfile']}", probe)},
            args.policies, args.seed, piece=256)["probe"]))
        print(f"rollout live-cost oracle: {len(probe)} interpreter answers in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        for i, (condition, w1, w64, bodies) in enumerate(cost_runs):
            pending.append((f"live-cost window {i + 1} ({condition})", bodies, w1[2] + w64[2],
                            ("probe_sar", "live_adm", 0), [], []))
        check_pending()
        # (condition, "c=1") -> p50 ms, (condition, "c=64") -> requests/s, per window
        vals: dict = {}
        for condition, w1, w64, _ in cost_runs:
            vals.setdefault((condition, "c=1"), []).append(pct(w1[1], 50) * 1e3)
            vals.setdefault((condition, "c=64"), []).append(len(w64[1]) / w64[0])
        a1, a64, b1, b64 = (float(np.median(vals[k])) for k in (
            ("alone", "c=1"), ("alone", "c=64"), ("beside", "c=1"), ("beside", "c=64")))
        print(f"rollout live cost of the shadow (sample rate 1.0, duty cycle 0.1; {card}): "
              f"medians over the windows alone -> beside, misses at c=1 p50 {a1:.3f} -> "
              f"{b1:.3f} ms ({100 * (b1 / a1 - 1):+.1f}%), at c=64 {a64:.1f} -> {b64:.1f} "
              f"requests/s ({100 * (b64 / a64 - 1):+.1f}%); each condition's range "
              + json.dumps({f"{m} {c}": [round(min(v), 3), round(max(v), 3)]
                            for (c, m), v in vals.items()})
              + "; windows in order " + " ".join(w[0] for w in cost_runs)
              + f", {ROLLOUT_C1} misses at c=1 and {ROLLOUT_C64} at c=64 each", flush=True)
    inj1 = injections(srv.mport)
    d_err = inj1["response_error"] - inj0["response_error"]
    d_deny = inj1["response_deny"] - inj0["response_deny"]
    if d_deny != injected["deny"] or not 0 <= d_err - injected["error"] <= injected["deny"]:
        problems.append(f"{injected} injected answers seen, the injector fired {d_err:g} / "
                        f"{d_deny:g}")
    text = http_get(srv.mport, "/metrics")[1].decode()
    problems += resilience_quiet("rollout", text)
    if metric_total(text, "cedar_authorizer_fallback_batches_total"):
        problems.append("fallback batches")
    served = {k: sum(e4[p]["launches"][k] - e0[p]["launches"][k] for p in e4)
              for k in e4["authorization"]["launches"]}
    launches = {k: served[k] + shadow_launches[k] for k in served}
    if not all(launches.values()):
        problems.append(f"a kernel did not launch in phase 18: {launches}")
    # the server's resident set now (the card machine's /proc has no
    # VmHWM); its peak over phases 15, 17 and 18 is obs_phase's line
    # after the SIGTERM (wait4's rusage)
    rss = "not measured"
    try:
        with open(f"/proc/{srv.proc.pid}/statm") as f:
            rss = f"{int(f.read().split()[1]) * os.sysconf('SC_PAGE_SIZE') / 2**20:.1f} MiB"
    except (OSError, IndexError, ValueError):
        pass
    print(f"rollout totals ({card}): launches served {json.dumps(served)} + shadow "
          f"{json.dumps(shadow_launches)}; injected {json.dumps(injected)}; server RSS at the "
          f"phase's end {rss}", flush=True)
    if problems:
        fail("rollout: " + "; ".join(problems))
    print(f"rollout phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


# phase 16's flags (both servers), beside phase 12's serving flags; the
# gate (LOAD_GATE) and the per-client quota, which needs C, only on the
# storm's server
LOAD_FLAGS = ("--reload-seconds", "1", "--shard-buckets", "64", "--slo-latency-budget-ms", "50",
              "--adaptive-batching", "--max-batch", "64",
              "--tuner-max-batch", "4096", "--tuner-interval-seconds", "0.5",
              "--tuner-burn-window-seconds", "10")
LOAD_GATE = 64
# the batch buckets a warm-up up to the tuner's clamp visits
LOAD_WARM_BUCKETS = [1, 8, 32, 128, 512, 1024, 2048, 4096]
SHED_PREFIX = "request shed under overload ("


def load_bodies(sars: list, seed: int) -> dict:
    """Phase 16's distinct bodies {key: (path, body, user, priority)}:
    256 kubelet SARs (pool bodies of no gated scope, their user
    system:node:node-<k> in group system:nodes); the pool's bodies of its
    64 most frequent users as the controllers' (the first, whose bodies
    are mostly gated, is the hot user); 256 admission reviews, each user
    one of 64 service accounts. Returns the bodies and the controller
    users, hot first."""
    import collections

    out = {}
    kube = [i for i in range(len(sars)) if i % 8][:256]
    for k, i in enumerate(kube):
        doc = json.loads(sars[i])
        user = f"system:node:node-{k % 64}"
        doc["spec"]["user"], doc["spec"]["groups"] = user, ["system:nodes"]
        out[("kubelet", k)] = ("/v1/authorize", json.dumps(doc).encode(), user, "high")
    users = [u for u, _ in collections.Counter(
        json.loads(b)["spec"]["user"] for b in sars).most_common(64)]
    for i, b in enumerate(sars):
        user = json.loads(b)["spec"]["user"]
        if user in users:
            out[("controller", i)] = ("/v1/authorize", b, user, "normal")
    for k, b in enumerate(admission_bodies(256, seed)):
        doc = json.loads(b)
        user = f"system:serviceaccount:team-{k % 8}:controller-{k % 64}"
        doc["request"]["userInfo"].update(username=user, uid=f"uid-{user}")
        out[("admission", k)] = ("/v1/admit", json.dumps(doc).encode(), user, "normal")
    return {"bodies": out, "users": users}


def load_mix(pool: dict, seed, hot_share: float = 1 / 3):
    """A seeded draw of phase 16's traffic -> a function returning the
    next body key: a kubelet SAR (25%), a controller SAR (50%; a
    `hot_share` of them the hot user's, the rest spread over the 63 other
    users) or an admission review (25%)."""
    by_user: dict = {}
    for key, (_p, _b, user, _pr) in pool["bodies"].items():
        if key[0] == "controller":
            by_user.setdefault(user, []).append(key)
    hot, others = pool["users"][0], pool["users"][1:]
    rng = random.Random(f"{seed}:mix")

    def draw():
        r = rng.random()
        if r < 0.25:
            return ("kubelet", rng.randrange(256))
        if r < 0.75:
            user = hot if rng.random() < hot_share else rng.choice(others)
            return rng.choice(by_user[user])
        return ("admission", rng.randrange(256))

    return draw


def load_schedule(C: float, pool: dict, seed: int) -> list:
    """[(due s, body key)]: the port's flash_crowd_schedule (base 0.5 C,
    peak 3 C, the crowd at 2 s with a 3 s ramp, 12 s), then 2 s of
    Poisson arrivals at the base (16 s and 4 s until the offline
    toolchain's slice needed the time), each arrival drawn from the full
    mix (load_mix)."""
    from cedar_tpu_torch.load import flash_crowd_schedule, poisson_schedule

    due = flash_crowd_schedule(0.5 * C, 3 * C, 2.0, 3.0, 12.0, seed=seed)
    due += [12.0 + t for t in poisson_schedule(0.5 * C, 2.0, seed=f"{seed}:tail")]
    draw = load_mix(pool, seed)
    return [(t, draw()) for t in due]


def stage_means(text0: str, text1: str, path: str) -> dict:
    """{stage: mean ms per batch} of cedar_pipeline_stage_seconds{path}
    between two /metrics texts."""
    a, b = stage_totals(text0, path), stage_totals(text1, path)
    return {st: round((v[0] - a.get(st, [0, 0])[0]) * 1e3
                      / max(v[1] - a.get(st, [0, 0])[1], 1), 3) for st, v in b.items()}


# the storm's fire-lag bound: past it the driver, not the server, set the
# offered rate, and the phase fails
STORM_LAG_P99_S = 0.050


def _storm_proc(port, items, n_conns, ready, go, t0, out_q):
    """One storm client process: opens its `n_conns` keep-alive
    connections, says so on `ready`, waits for `go`, then fires each of
    its arrivals at its due time (monotonic `t0.value` + due) on an idle
    connection of its pool, opening another when none is idle, so no
    arrival waits for an answer to an earlier one. Puts ([(index,
    status, body bytes, Retry-After, fire lag s, latency s, error, send
    time, opened a connection)], connections opened) on `out_q`."""
    import asyncio

    out_q.put(asyncio.run(_storm_async(port, items, n_conns, ready, go, t0)))


async def _storm_async(port: int, items: list, n_conns: int, ready, go, t0_shared):
    import asyncio

    idle: list = []
    opened = [0]

    async def connect():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.get_extra_info("socket").setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        opened[0] += 1
        return reader, writer

    async def exchange(conn, path: str, body: bytes):
        reader, writer = conn
        writer.write(b"POST %s HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json"
                     b"\r\nContent-Length: %d\r\n\r\n%s" % (path.encode(), len(body), body))
        status = int((await reader.readline()).split()[1])
        length, retry, close = 0, None, False
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            name, value = name.strip().lower(), value.strip()
            if name == "content-length":
                length = int(value)
            elif name == "retry-after":
                retry = value
            elif name == "connection":
                close = value.lower() == "close"
        return status, await reader.readexactly(length), retry, close

    out = [None] * len(items)

    async def fire(j: int):
        k, due, path, body = items[j]
        conn = idle.pop() if idle else None
        fresh = conn is None
        t_send = time.monotonic()
        try:
            if conn is None:
                conn = await connect()
                t_send = time.monotonic()
            status, data, retry, close = await asyncio.wait_for(exchange(conn, path, body), 60)
            out[j] = (k, status, data, retry, t_send - (t0 + due), time.monotonic() - t_send,
                      None, t_send, fresh)
            if close:
                conn[1].close()
            else:
                idle.append(conn)
        except Exception as e:  # noqa: BLE001 — reported by the phase
            out[j] = (k, None, None, None, t_send - (t0 + due), None, repr(e), t_send, fresh)
            if conn is not None:
                conn[1].close()

    idle.extend(await asyncio.gather(*(connect() for _ in range(n_conns))))
    ready.put(os.getpid())
    go.wait()  # nothing else runs on this loop yet
    t0 = t0_shared.value
    tasks = []
    for j, (_k, due, _p, _b) in enumerate(items):
        wait = t0 + due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        tasks.append(asyncio.ensure_future(fire(j)))
    await asyncio.gather(*tasks)
    for _r, w in idle:
        w.close()
    return out, opened[0]


def storm(port: int, schedule: list, bodies: dict, n_procs: int = 4, n_conns: int = 256):
    """Fire `schedule` ([(due s, body key)]) open loop from `n_procs`
    spawned processes (arrival i from process i mod n_procs), each
    starting with `n_conns` keep-alive connections and opening more
    whenever every one is busy. The schedule's clock starts 0.5 s after
    every process has started and connected, so a slow start delays
    the storm, not its arrivals -> (one record per arrival, in order:
    index, status, body, Retry-After, fire lag, latency, error, send
    time, opened a connection; the connections opened); the processes
    are gone on return."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    ready, go, out_q = ctx.Queue(), ctx.Event(), ctx.Queue()
    t0 = ctx.Value("d", 0.0)
    procs = []
    for p in range(n_procs):
        items = [(i, due, bodies[key][0], bodies[key][1])
                 for i, (due, key) in enumerate(schedule) if i % n_procs == p]
        procs.append(ctx.Process(target=_storm_proc,
                                 args=(port, items, n_conns, ready, go, t0, out_q)))
    t_start = time.monotonic()
    try:
        for proc in procs:
            proc.start()
        try:
            for _ in procs:
                ready.get(timeout=120)
        except queue.Empty:
            fail("load storm: a client process did not start and connect within 120 s")
        t0.value = time.monotonic() + 0.5
        print(f"load storm: {n_procs} client processes started and connected "
              f"{n_procs * n_conns} connections in {time.monotonic() - t_start:.2f} s",
              flush=True)
        go.set()
        last_due = max((due for due, _k in schedule), default=0.0)
        try:
            parts = [out_q.get(timeout=last_due + 180) for _ in procs]
        except queue.Empty:
            fail("load storm: a client process did not report its arrivals")
        for proc in procs:
            proc.join(timeout=60)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    records = [None] * len(schedule)
    for part, _opened in parts:
        for rec in part:
            records[rec[0]] = rec
    return records, sum(opened for _part, opened in parts)


def peak_outstanding(records: list) -> int:
    """The most requests the storm held unanswered at once (send to
    answer, every process together)."""
    events = []
    for r in records:
        if r[5] is not None:
            events += [(r[7], 1), (r[7] + r[5], -1)]
    peak = cur = 0
    for _t, d in sorted(events, key=lambda e: (e[0], e[1])):
        cur += d
        peak = max(peak, cur)
    return peak


class ReadyzPoller:
    """GET /readyz every 100 ms on its own thread: (monotonic, status,
    body) per read."""

    def __init__(self, mport: int):
        self.mport, self.reads = mport, []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.1):
            t = time.monotonic()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{self.mport}/readyz",
                                            timeout=10) as r:
                    self.reads.append((t, r.status, r.read().decode()))
            except urllib.error.HTTPError as e:
                self.reads.append((t, e.code, e.read().decode()))
            except OSError as e:
                self.reads.append((t, None, repr(e)))

    def __enter__(self):
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(timeout=30)
        return False


def shed_of(path: str, status: int, data: bytes, retry, uid: str):
    """A shed answer's reason, None for a served answer; raises
    ValueError when a shed answer is not the honest shape: NoOpinion with
    the evaluationError "request shed under overload (<reason>); retry
    after 1s" on /v1/authorize, the fail-open review (allowed, code 500,
    the same message and " (allowed on shed)", the request's uid) on
    /v1/admit; Retry-After 1 on an ingress shed, none on an
    evaluation-stage shed (eval_saturated)."""
    doc = json.loads(data)
    if path == "/v1/admit":
        resp = doc["response"]
        msg = resp["status"]["message"]
        if SHED_PREFIX not in msg:
            return None
        reason = msg[len(SHED_PREFIX):].split(")")[0]
        want = {"uid": uid, "allowed": True, "status": {
            "code": 500, "message": f"{SHED_PREFIX}{reason}); retry after 1s (allowed on shed)"}}
        shape = resp == want
    else:
        st = doc["status"]
        err = st.get("evaluationError") or ""
        if not err.startswith(SHED_PREFIX):
            return None
        reason = err[len(SHED_PREFIX):].split(")")[0]
        shape = st == {"allowed": False, "denied": False, "reason": "",
                       "evaluationError": f"{SHED_PREFIX}{reason}); retry after 1s"}
    want_retry = None if reason == "eval_saturated" else "1"
    if not shape or status != 200 or retry != want_retry:
        raise ValueError(f"dishonest shed on {path}: HTTP {status}, Retry-After {retry}: "
                         f"{data[:300]!r}")
    return reason


def load_phase(args, card: str, sars: list) -> dict:
    """Phase 16 (module docstring): the overload-control plane in front of
    both webhook paths of the CLI over phase 12's Policy objects, under an
    open-loop flash crowd. `sars` is phase 12's SAR pool. Returns the
    kernels' served launches over the storm, both engines."""
    t_phase = time.monotonic()
    grace = 5.0
    pool = load_bodies(sars, args.seed + 16)
    bodies = pool["bodies"]
    keys = list(bodies)
    base = crd_objects(args.policies, args.seed)
    api = FakeApiServer(hold_s=30.0)
    problems = []
    with tempfile.TemporaryDirectory(prefix="cedar-load-") as tmp:
        vfile = os.path.join(tmp, "v0.json")
        with open(vfile, "w") as f:
            json.dump([{"metadata": {"name": n, "uid": f"uid-{n}"}, "spec": {"content": c}}
                       for n, c in base.items()], f)
        for name, content in base.items():
            api.apply(name, content)
        kube = api.kubeconfig(os.path.join(tmp, "kubeconfig.json"))
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "crd", "crdStore": {}}]}}, f)
        # the probe server: the phase's flags without the gate, so C is
        # what the server serves, not what a gate lets through
        srv = Webhook(cfg, tmp, "webhook-load-probe", grace,
                      ("--kubeconfig", kube, *LOAD_FLAGS, "--max-inflight", "0"))
        try:
            # the oracle alongside the server's start-up
            t0 = time.monotonic()
            sar_keys = [k for k in keys if bodies[k][0] == "/v1/authorize"]
            adm_keys = [k for k in keys if bodies[k][0] == "/v1/admit"]
            answers = interpreter_answers(
                {"sar": (f"crd-authorize:{vfile}", [bodies[k][1] for k in sar_keys]),
                 "adm": (f"crd-admit:{vfile}", [bodies[k][1] for k in adm_keys])},
                args.policies, args.seed, piece=128)
            want = {k: a for k, a in zip(sar_keys, answers["sar"])}
            want.update({k: adm_key(a["response"]) for k, a in zip(adm_keys, answers["adm"])})
            print(f"load oracle: {len(want)} interpreter answers in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            srv.wait_ready(card)
            # C: the answers a second of a 3 s closed loop at c=64 of the
            # mix without the hot user (every client below its quota) on
            # the ungated server
            draw = load_mix(pool, f"{args.seed}:probe", hot_share=0.0)
            flips = []
            probe = {"admitted": 0, "shed": 0, "stop": time.monotonic() + 3.0}
            lock = threading.Lock()

            def prober():
                conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
                try:
                    while time.monotonic() < probe["stop"]:
                        with lock:
                            key = draw()
                        path, body = bodies[key][:2]
                        conn.request("POST", path, body=body,
                                     headers={"Content-Type": "application/json"})
                        resp = conn.getresponse()
                        data = resp.read()
                        uid = json.loads(body)["request"]["uid"] if path == "/v1/admit" else ""
                        if shed_of(path, resp.status, data, resp.getheader("Retry-After"),
                                   uid) is not None:
                            with lock:
                                probe["shed"] += 1
                            continue
                        doc = json.loads(data)
                        got = adm_key(doc["response"]) if path == "/v1/admit" else canon(doc)
                        if got != want[key]:
                            flips.append((path, key, got))
                        with lock:
                            probe["admitted"] += 1
                except Exception as e:  # noqa: BLE001 — reported below
                    problems.append(f"probe client: {e!r}")
                finally:
                    conn.close()

            t = time.perf_counter()
            threads = [threading.Thread(target=prober) for _ in range(64)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            C = probe["admitted"] / (time.perf_counter() - t)
            text = http_get(srv.mport, "/metrics")[1].decode()
            problems += resilience_quiet("load probe", text)
            print(f"load probe ({card}): C = {C:.1f} requests/s ({probe['admitted']} answers "
                  f"of the mix without the hot user at c=64 in 3 s, no gate)", flush=True)
            if probe["shed"]:
                problems.append(f"{probe['shed']} shed answers from the ungated server")
            if problems:
                fail("load probe: " + "; ".join(problems))
            srv.terminate()
        finally:
            srv.kill()
        qps = round(0.05 * C, 3)
        srv = Webhook(cfg, tmp, "webhook-load", grace,
                      ("--kubeconfig", kube, *LOAD_FLAGS, "--max-inflight", str(LOAD_GATE),
                       "--client-qps", str(qps)))
        try:
            srv.wait_ready(card)

            def launches():
                doc = srv.debug_engine()
                return {k: sum(doc[p]["engine"]["launches"][k]
                               for p in ("authorization", "admission"))
                        for k in doc["authorization"]["engine"]["launches"]}

            schedule = load_schedule(C, pool, args.seed)
            text0 = http_get(srv.mport, "/metrics")[1].decode()
            l0 = launches()
            t_storm = time.monotonic()
            with ReadyzPoller(srv.mport) as poller:
                records, opened = storm(srv.port, schedule, bodies)
            storm_s = time.monotonic() - t_storm
            l1 = launches()
            launches_load = {k: l1[k] - l0[k] for k in l1}
            errors = [r[6] for r in records if r is None or r[6] is not None]
            if errors:
                fail(f"load storm: {len(errors)} client errors, first {errors[:3]}")
            dl = json.loads(http_get(srv.mport, "/debug/load")[1])
            eng = srv.debug_engine()
            text = http_get(srv.mport, "/metrics")[1].decode()

            # every answer: a shed of the honest shape, a deadline, or a
            # served answer equal to the interpreter's
            shed_by: dict = {}
            ingress_shed = eval_shed = deadlines = 0
            quota_users: dict = {}
            lat: dict = {}
            prio_of = {}
            normal_total = {"all": 0, "peak": 0}
            normal_shed = {"all": 0, "peak": 0}
            for (due, key), rec in zip(schedule, records):
                path, _body, user, prio = bodies[key]
                _i, status, data, retry, _lag, dt, _err, _t, _fresh = rec
                uid = json.loads(_body)["request"]["uid"] if path == "/v1/admit" else ""
                try:
                    reason = shed_of(path, status, data, retry, uid)
                except ValueError as e:
                    fail(f"load: {e}")
                peak = 5.0 <= due < 8.0
                if prio == "normal":
                    normal_total["all"] += 1
                    normal_total["peak"] += peak
                if reason is not None:
                    shed_by[f"{prio}/{reason}"] = shed_by.get(f"{prio}/{reason}", 0) + 1
                    if reason == "eval_saturated":
                        eval_shed += 1
                    else:
                        ingress_shed += 1
                    if reason == "client_quota":
                        quota_users[user] = quota_users.get(user, 0) + 1
                    if prio == "normal":
                        normal_shed["all"] += 1
                        normal_shed["peak"] += peak
                    continue
                endpoint = "admission" if path == "/v1/admit" else "authorization"
                lat.setdefault((prio, endpoint), []).append(dt)
                if path == "/v1/admit":
                    got = adm_key(json.loads(data)["response"])
                    if "deadline" in got[3] and got[2] == 500:
                        deadlines += 1
                        continue
                else:
                    got = canon(json.loads(data))
                    if "deadline" in (got.get("evaluationError") or ""):
                        deadlines += 1
                        continue
                if got != want[key]:
                    flips.append((path, key, got))
            n = len(records)
            admitted = n - ingress_shed
            ac = dl["admission_control"]
            for f_ in flips[:3]:
                print(f"load flip: {f_[0]} {f_[1]}: got {json.dumps(f_[2])[:300]}, want "
                      f"{json.dumps(want[f_[1]])[:300]}", flush=True)
            if flips:
                problems.append(f"{len(flips)} flips")
            if (ac["offered"], ac["admitted"], ac["shed"], ac["eval_shed"]) != (
                    n, admitted, ingress_shed, eval_shed) or ac["offered"] != \
                    ac["admitted"] + ac["shed"]:
                problems.append(f"server offered/admitted/shed/eval_shed {ac['offered']} / "
                                f"{ac['admitted']} / {ac['shed']} / {ac['eval_shed']}, clients "
                                f"{n} / {admitted} / {ingress_shed} / {eval_shed}")
            if ac["shed_by"] != shed_by:
                problems.append(f"server shed_by {ac['shed_by']}, clients {shed_by}")
            metric_sheds = metric_total(text, "cedar_load_shed_total")
            if metric_sheds != ingress_shed + eval_shed:
                problems.append(f"cedar_load_shed_total {metric_sheds:g}, shed answers "
                                f"{ingress_shed + eval_shed}")
            states = sorted({body for _t, _s, body in poller.reads})
            bad_ready = [r for r in poller.reads if r[1] != (503 if r[2] == "saturated" else 200)]
            if bad_ready:
                problems.append(f"/readyz: {bad_ready[:3]}")
            high_sheds = sum(v for k, v in shed_by.items() if k.startswith("high/"))
            if high_sheds and "saturated" not in states:
                problems.append(f"{high_sheds} high-priority sheds, /readyz never read saturated")
            if not normal_shed["all"]:
                problems.append("the storm shed no normal-priority request: not an overload")
            hot = pool["users"][0]
            if not quota_users.get(hot) or set(quota_users) != {hot}:
                problems.append(f"client_quota sheds by user {quota_users}, want the hot user "
                                f"{hot} only")
            throttled = {ln.split('client="')[1].split('"')[0] for ln in text.splitlines()
                         if ln.startswith("cedar_client_throttled_total{")}
            if throttled != set(quota_users):
                problems.append(f"cedar_client_throttled_total clients {throttled}")
            problems += resilience_quiet("load", text)
            # the tuners: every move inside its bounds; the warm-up
            # visited every bucket up to the clamp, and no batch met a
            # bucket above it
            moves = {}
            for p_, st in dl["tuning"].items():
                b = st["bounds"]
                lim = {"max_batch": (b["min_batch"], b["max_batch"]),
                       "linger_us": (b["min_window_us"], b["max_window_us"])}
                out_of = [d for d in st["decisions"]
                          if not lim[d["param"]][0] <= d["to"] <= lim[d["param"]][1]]
                if out_of or not lim["max_batch"][0] <= st["max_batch"] <= lim["max_batch"][1]:
                    problems.append(f"tuner {p_}: moves out of bounds {out_of[:3]}")
                moves[p_] = st
                e = eng[p_]["engine"]
                if e["warm_buckets"] != LOAD_WARM_BUCKETS:
                    problems.append(f"{p_} engine warmed {e['warm_buckets']}, want "
                                    f"{LOAD_WARM_BUCKETS}")
                if max(e["staging"]["buckets"], default=0) > LOAD_WARM_BUCKETS[-1]:
                    problems.append(f"{p_} engine met buckets {e['staging']['buckets']}")
            if not all(launches_load.values()):
                problems.append(f"a kernel did not launch in the storm: {launches_load}")

            # the offered rate from the sends themselves, and whether the
            # driver kept to the schedule
            lags = [r[4] for r in records]
            sends = [r[7] for r in records]
            span = max(sends) - min(sends)
            if pct(lags, 99) > STORM_LAG_P99_S:
                problems.append(f"storm fire lag p99 {pct(lags, 99) * 1e3:.3f} ms, bound "
                                f"{STORM_LAG_P99_S * 1e3:g} ms: the driver, not the schedule, "
                                f"set the offered rate")
            outstanding = peak_outstanding(records)
            # when the tail happened: admitted p99 per priority in 2 s
            # windows of the schedule
            windows: dict = {}
            for (due, key), rec in zip(schedule, records):
                if rec[5] is not None:
                    windows.setdefault((bodies[key][3], int(due // 2) * 2), []).append(rec[5])
            print(f"load latency by 2 s window ({card}), p99 ms of every answer: " + json.dumps(
                {f"{pr}@{w}": round(pct(v, 99) * 1e3, 1)
                 for (pr, w), v in sorted(windows.items())}), flush=True)
            for p_ in ("authorization", "admission"):
                print(f"load stage means over the storm, {p_} ({card}), ms per batch: "
                      + json.dumps(stage_means(text0, text, p_)), flush=True)
            print(f"load storm ({card}): C {C:.1f} requests/s, quota {qps:g}/s; {n} arrivals "
                  f"in {span:.2f} s: offered {n / span:.1f} requests/s, admitted "
                  f"{admitted / span:.1f} requests/s ({ac['admitted']} admitted, "
                  f"{ac['shed']} shed at ingress, {ac['eval_shed']} at evaluation, "
                  f"{deadlines} deadlines); normal traffic shed {normal_shed['all']} of "
                  f"{normal_total['all']}, at the peak (5-8 s) {normal_shed['peak']} of "
                  f"{normal_total['peak']}", flush=True)
            print("load sheds by priority/reason: " + json.dumps(dict(sorted(shed_by.items())))
                  + f"; client_quota by user {json.dumps(quota_users)}", flush=True)
            print(f"load admitted latency ({card}), ms: " + json.dumps(
                {f"{pr}/{ep}": {"n": len(v), "p50": round(pct(v, 50) * 1e3, 3),
                                "p99": round(pct(v, 99) * 1e3, 3)}
                 for (pr, ep), v in sorted(lat.items())}), flush=True)
            counts = {s: sum(1 for r in poller.reads if r[2] == s) for s in states}
            print(f"load /readyz: {len(poller.reads)} reads, states " + json.dumps(counts),
                  flush=True)
            for p_, st in moves.items():
                seq = [f"{d['param']} {d['from']:g}->{d['to']:g} (burn {d['latency_burn']}, "
                       f"queue {d['queue_fill']})" for d in st["decisions"]]
                print(f"load tuner {p_}: {st['moves']} moves in {st['ticks']} ticks, final "
                      f"max_batch {st['max_batch']} linger_us {st['linger_us']}; first "
                      + "; ".join(seq[:6]), flush=True)
            peak_sends = [r[7] for (due, _k), r in zip(schedule, records) if 5.0 <= due < 8.0]
            peak_rate = len(peak_sends) / max(max(peak_sends) - min(peak_sends), 1e-9)
            print(f"load storm client fire lag: p50 {pct(lags, 50) * 1e3:.3f} ms, p99 "
                  f"{pct(lags, 99) * 1e3:.3f} ms, max {max(lags) * 1e3:.3f} ms; sent at the "
                  f"peak (5-8 s) {peak_rate:.1f} requests/s = {peak_rate / C:.2f} C; at most "
                  f"{outstanding} requests unanswered at once (gate {LOAD_GATE}) over "
                  f"{opened} connections; storm {storm_s:.1f} s; launches "
                  f"{json.dumps(launches_load)}", flush=True)
            # where a late fire came from: an arrival that found no idle
            # connection waited for its connect
            fresh = [r[4] for r in records if r[8]]
            late = [r for r in records if r[4] > STORM_LAG_P99_S]
            print(f"load storm fire lag by connection: {len(fresh)} arrivals opened one"
                  + (f" (lag p99 {pct(fresh, 99) * 1e3:.3f} ms)" if fresh else "")
                  + f"; {len(late)} arrivals over {STORM_LAG_P99_S * 1e3:g} ms, "
                  f"{sum(1 for r in late if r[8])} of them opening one; deadlines "
                  f"{deadlines}", flush=True)
            if problems:
                fail("load: " + "; ".join(problems))
            took, rss = srv.terminate()
            print(f"load webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()
            api.shutdown()
    print(f"load phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches_load


# ---------------------------------------------------------------------------
# phase 19: the declarative policy lifecycle

# the live set of phase 19's server: phase 12's objects without their two
# interpreter-fallback policies, one file per object; tenant-good's
# candidate is that set plus LIFECYCLE_ADDED_POLICY, a permit for a user
# the traffic never sends (the analyze gate's intent); tenant-breach's is
# a directory holding an interpreter-fallback policy
LIFECYCLE_NEWCOMER = "lifecycle-newcomer"
LIFECYCLE_ADDED_POLICY = (f'permit (principal == k8s::User::"{LIFECYCLE_NEWCOMER}", action,\n'
                          "        resource is k8s::Resource);\n")
LIFECYCLE_GOOD, LIFECYCLE_BREACH = "tenant-good", "tenant-breach"
LIFECYCLE_WALK = ["pending", "verifying", "analyzing", "shadowing", "promoting", "promoted"]
# distinct SARs the phase's traffic cycles through (768 until the offline
# toolchain's slice needed the time: the interpreter answers each twice)
LIFECYCLE_POOL = 384
# 256 and 4 s until the offline toolchain's slice needed the time
LIFECYCLE_MIN_SAMPLES = 128
LIFECYCLE_AFTER_S = 2.0  # traffic kept up after the promotion


def lifecycle_objects(n_policies: int, seed: int) -> dict:
    """Phase 19's live set {name: content}: phase 12's objects with the
    interpreter-fallback policies left out, as phase 18's candidate leaves
    them out (the strict stage gate refuses a candidate that holds one)."""
    objs = crd_objects(n_policies, seed)
    objs["gated"] = NATIVE_OPAQUE_POLICY
    objs["admission"] = ADM_POLICIES + ADM_DEMO_OWNER_POLICY
    return objs


def _write_policy_dir(path: str, files: dict) -> str:
    os.makedirs(path, exist_ok=True)
    for name, content in files.items():
        with open(os.path.join(path, f"{name}.cedar"), "w") as f:
            f.write(content)
    return path


def lifecycle_specs(spec_dir: str, good_dir: str, breach_dir: str) -> None:
    """The two PolicyRollout manifests of phase 19's server, named so that
    tenant-breach sorts (and so ticks) first: its automatic rollback is a
    no-op only while nothing is staged."""
    os.makedirs(spec_dir, exist_ok=True)
    docs = {
        f"01-{LIFECYCLE_BREACH}.json": {
            "kind": "PolicyRollout", "metadata": {"name": LIFECYCLE_BREACH},
            "spec": {"candidate": {"directory": breach_dir},
                     "gates": {"lowerability_floor_pct": 100.0},
                     "promotion": {"mode": "auto", "canary_ladder": []}}},
        f"02-{LIFECYCLE_GOOD}.json": {
            "kind": "PolicyRollout", "metadata": {"name": LIFECYCLE_GOOD},
            "spec": {"candidate": {"directory": good_dir},
                     "gates": {"analyze": {"flip_budget": 0, "allowed_intents": [
                         {"kind": "deny_to_allow",
                          "principal": f"k8s::User::{LIFECYCLE_NEWCOMER}"}]},
                         "shadow": {"min_samples": LIFECYCLE_MIN_SAMPLES, "diff_budget": 0}},
                     "promotion": {"mode": "manual", "canary_ladder": []},
                     "stage_deadline_s": 600}},
    }
    for name, doc in docs.items():
        with open(os.path.join(spec_dir, name), "w") as f:
            json.dump(doc, f)


class LifecycleTraffic:
    """Phase 19's traffic: ``clients`` keep-alive connections POST the
    pool's SARs in turn, each pausing ``pause_s`` between requests, until
    stop(). Every answer is kept as (perf_counter at send, at receipt,
    pool index, status); nothing is retried."""

    def __init__(self, port: int, pool: list, clients: int = 2, pause_s: float = 0.005):
        self.port, self.pool, self.clients, self.pause_s = port, pool, clients, pause_s
        self.records: list = []
        self.errors: list = []
        self._next = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run) for _ in range(clients)]

    def _run(self):
        c = Client(self.port)
        try:
            while not self._stop.is_set():
                with self._lock:
                    i = self._next % len(self.pool)
                    self._next += 1
                t = time.perf_counter()
                status, _ = c.post(self.pool[i])
                self.records.append((t, time.perf_counter(), i, status))
                time.sleep(self.pause_s)
        except Exception as e:  # noqa: BLE001 — reported by the phase
            self.errors.append(repr(e))
        finally:
            c.close()

    def start(self):
        for th in self._threads:
            th.start()
        return self

    def stop(self) -> list:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=60)
        return sorted(self.records)


_IDLE_FRAMES = ("wait", "select", "get", "sleep", "accept", "_worker", "readinto", "poll",
                "serve_forever", "recv_into")


def pprof_top(port: int, n: int = 3, busy: bool = False) -> tuple:
    """One GET /debug/pprof/profile -> (samples, [(count, innermost frames)])
    of the n most frequent stacks; ``busy`` leaves out the stacks parked
    in a wait (a lock, a queue, a socket, a sleep)."""
    text = http_get(port, "/debug/pprof/profile")[1].decode()
    lines = text.splitlines()
    samples = int(lines[0].split()[1])
    stacks, cur = [], None
    for line in lines[1:]:
        if line.endswith(" samples:"):
            cur = (int(line.split()[0]), [])
            stacks.append(cur)
        elif line.startswith("  ") and cur is not None:
            cur[1].append(line.strip())
    if busy:
        stacks = [(k, fr) for k, fr in stacks
                  if fr and fr[-1].rsplit(" ", 1)[-1] not in _IDLE_FRAMES]
    return samples, [(k, frames[-4:]) for k, frames in stacks[:n]]


def lifecycle_sweep(card: str, engine, tiers, problems: list) -> None:
    """Phase 19 (b): the device-exact sweep of the engine's 10k set, its
    rule bitsets fetched through the engine on the card, against the host
    route over the same pack."""
    import torch

    from cedar_tpu_torch.analysis import semdiff

    packed = engine._compiled.packed
    t0 = time.perf_counter()
    dev = semdiff.sweep(tiers, engine=engine, packed=packed)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = semdiff.sweep(tiers, packed=packed)
    t_host = time.perf_counter() - t0
    for part in ("dead", "shadowed", "overlaps"):
        if getattr(dev, part) != getattr(host, part):
            problems.append(f"sweep {part}: the engine route differs from the host route")
    if dev.match_counts != host.match_counts:
        problems.append("sweep match_counts: the engine route differs from the host route")
    for label, res in (("engine", dev), ("host", host)):
        if res.oracle["disagreements"]:
            problems.append(f"sweep ({label}): {res.oracle['disagreements']} oracle disagreements")
    codes, extras = semdiff.encode_universe(packed, dev.universe)
    t0 = time.perf_counter()
    on_card = semdiff._engine_sat_matrix(engine, packed, codes, extras)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_host = semdiff._host_sat_matrix(packed, codes, extras)
    t_hsat = time.perf_counter() - t0
    if on_card.tobytes() != on_host.tobytes():
        problems.append("sweep: the engine's sat matrix differs from _host_sat_matrix")
    print(f"lifecycle sweep ({card}): {dev.n_policies} policies, {dev.n_rules} rules, universe "
          f"{json.dumps(dev.universe.to_dict())}; sweep through the engine {t_dev:.3f} s, on the "
          f"host {t_host:.3f} s; dead {len(dev.dead)}, shadowed {len(dev.shadowed)}, overlaps "
          f"{len(dev.overlaps)}, oracle {dev.oracle['sampled']} sampled / "
          f"{dev.oracle['disagreements']} disagreements; sat matrix [{on_card.shape[0]}, "
          f"{on_card.shape[1]}] through the engine {t_card * 1e3:.3f} ms, on the host "
          f"{t_hsat * 1e3:.3f} ms, byte-equal {on_card.tobytes() == on_host.tobytes()}",
          flush=True)


def lifecycle_phase(args, card: str, corpus, engine, tiers) -> dict:
    """Phase 19 (module docstring). (a) a server over the lifecycle's live
    set with two PolicyRollout specs: tenant-breach halts at verifying and
    rolls back, tenant-good walks verify -> analyze -> shadow, holds for
    approval, is approved over POST /lifecycle/approve and promoted; every
    answer held to the interpreter over the set live when it was served;
    (b) the device-exact sweep on ``engine`` (run while the server starts);
    (c) under --only-lifecycle only, the embedded canary router and a crash
    resume. Returns the kernels' launches on the lifecycle path: the
    server's served ones, the shadow worker's and the candidate engines'
    warm-ups."""
    t_phase = time.monotonic()
    problems = []
    grace = 5.0
    pool = cache_working_set(gated_bodies(corpus, 2 * LIFECYCLE_POOL, seed=args.seed + 19),
                             LIFECYCLE_POOL)
    live = lifecycle_objects(args.policies, args.seed)
    with tempfile.TemporaryDirectory(prefix="cedar-lifecycle-") as tmp:
        live_dir = _write_policy_dir(os.path.join(tmp, "live"), live)
        good_dir = _write_policy_dir(os.path.join(tmp, "candidate-good"),
                                     {**live, LIFECYCLE_NEWCOMER: LIFECYCLE_ADDED_POLICY})
        breach_dir = _write_policy_dir(os.path.join(tmp, "candidate-breach"),
                                       {"fallback": FALLBACK_POLICY})
        spec_dir = os.path.join(tmp, "specs")
        lifecycle_specs(spec_dir, good_dir, breach_dir)
        journal, audit = os.path.join(tmp, "journal.jsonl"), os.path.join(tmp, "audit.jsonl")
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"spec": {"stores": [{"type": "directory",
                                            "directoryStore": {"path": live_dir}}]}}, f)
        flags = ("--request-timeout-ms", "10000", "--rollout-insecure-control",
                 "--lifecycle-spec-dir", spec_dir, "--lifecycle-journal-file", journal,
                 "--lifecycle-interval-seconds", "0.5", "--audit-log-file", audit, "--profiling")
        srv = Webhook(cfg, tmp, "webhook-lifecycle", grace, flags)
        try:
            # ---- (b) the device-exact sweep, while the server starts
            if engine is not None:
                lifecycle_sweep(card, engine, tiers, problems)
            srv.wait_ready(card)
            launches = lifecycle_serve(card, srv, pool, journal, audit, problems)
            took, rss = srv.terminate()
            print(f"lifecycle webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()
        answers, t_oracle = lifecycle_oracle(args, pool, live_dir, good_dir)
        lifecycle_flips(card, launches.pop("_records"), launches.pop("_marks"), answers,
                        t_oracle, problems)
        if args.only_lifecycle:
            lifecycle_canary(card, engine, tiers, pool, problems)
            lifecycle_resume(card, tmp, cfg, good_dir, problems)
    if problems:
        fail("lifecycle: " + "; ".join(problems))
    print(f"lifecycle phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


def _lifecycle_doc(srv) -> dict:
    return json.loads(http_get(srv.mport, "/debug/lifecycle")[1])


def _rollout_doc(srv) -> dict:
    return json.loads(http_get(srv.mport, "/debug/rollout")[1])


def lifecycle_serve(card, srv, pool, journal, audit, problems) -> dict:
    """Phase 19 (a) on the running server: traffic throughout, the walk
    polled on /debug/lifecycle, one profile while the candidate shadows,
    the approval, the promotion; then the journal, the audit log and
    /metrics. Returns the launches, with the traffic's records and the
    times that split them (popped by the caller)."""
    e0 = srv.debug_engine()
    traffic = LifecycleTraffic(srv.port, pool).start()
    seen = {LIFECYCLE_GOOD: [], LIFECYCLE_BREACH: []}  # (stage, evidence keys) in order
    evals = []  # (perf_counter, shadow evaluations) while tenant-good shadows
    t_ready_unix = profile = staged_at = None
    deadline = time.monotonic() + 600
    while True:
        doc = _lifecycle_doc(srv)
        for tenant, walk in seen.items():
            t_doc = doc["tenants"].get(tenant)
            if t_doc is None:
                continue
            entry = (t_doc["stage"], sorted(t_doc["evidence"]))
            if not walk or walk[-1] != entry:
                walk.append(entry)
        good = doc["tenants"][LIFECYCLE_GOOD]
        if good["stage"] in ("halted", "rolled_back", "failed"):
            fail(f"lifecycle: {LIFECYCLE_GOOD} ended {good['stage']}: "
                 f"{json.dumps(good)[:1500]}\n{srv.log()}")
        if good["stage"] == "shadowing":
            ro = _rollout_doc(srv)
            cand = ro.get("candidate") or {}
            staged_at = cand.get("staged_at", staged_at)
            if t_ready_unix is None and cand.get("warm_state") == "ready":
                t_ready_unix = time.time()
            if ro.get("diff"):
                evals.append((time.perf_counter(), sum(ro["diff"]["evaluations"].values())))
            if profile is None:
                profile = pprof_top(srv.port)
        if good["awaiting_approval"] and t_ready_unix is not None:
            break
        if time.monotonic() > deadline:
            fail(f"lifecycle: {LIFECYCLE_GOOD} not awaiting approval within 600 s: "
                 f"{json.dumps(doc)[:1500]}\n{srv.log()}")
        time.sleep(0.1)
    ro = _rollout_doc(srv)
    shadow_launches = dict(ro["shadow_launches"])
    warm = ro["candidate"]["warm_stats"]
    warm_launches = {k: sum(w["launches"].get(k, 0) for w in warm.values())
                     for k in shadow_launches}
    diff = ro["diff"]
    # ---- the approval and the promotion
    t_approve = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{srv.mport}/lifecycle/approve", method="POST",
                                 data=json.dumps({"tenant": LIFECYCLE_GOOD}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        code, approved = r.status, json.loads(r.read())
    approve_s = time.perf_counter() - t_approve
    if code != 200 or approved.get("approved") is not True:
        fail(f"lifecycle approve: {code} {approved}")
    while _rollout_doc(srv)["state"] != "promoted":
        if time.perf_counter() - t_approve > 120:
            fail(f"lifecycle: not promoted within 120 s of the approval:\n{srv.log()}")
        time.sleep(0.02)
    t_promoted = time.perf_counter()
    while True:
        doc = _lifecycle_doc(srv)
        stage = doc["tenants"][LIFECYCLE_GOOD]["stage"]
        entry = (stage, sorted(doc["tenants"][LIFECYCLE_GOOD]["evidence"]))
        if seen[LIFECYCLE_GOOD][-1] != entry:
            seen[LIFECYCLE_GOOD].append(entry)
        if stage == "promoted":
            break
        if time.perf_counter() - t_approve > 120:
            fail(f"lifecycle: {LIFECYCLE_GOOD} at {stage} 120 s after the approval")
        time.sleep(0.05)
    time.sleep(LIFECYCLE_AFTER_S)
    records = traffic.stop()
    if traffic.errors:
        fail(f"lifecycle traffic: client errors {traffic.errors[:3]}")
    e1 = srv.debug_engine()
    final = _lifecycle_doc(srv)
    text = http_get(srv.mport, "/metrics")[1].decode()

    # ---- the walk, the evidence, the journal, the metrics, the audit log
    g, b = final["tenants"][LIFECYCLE_GOOD], final["tenants"][LIFECYCLE_BREACH]
    ev = g["evidence"]
    an = ev.get("analyze", {})
    with open(journal) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    walk = {t: [(r["from"], r["to"]) for r in recs if r.get("tenant") == t and r.get("to")
                and r.get("event") == "transition"] for t in seen}
    events = {t: [r["event"] for r in recs if r.get("tenant") == t] for t in seen}
    want_good = list(zip(LIFECYCLE_WALK, LIFECYCLE_WALK[1:]))
    want_breach = [("pending", "verifying"), ("verifying", "halted"), ("halted", "rolled_back")]
    if walk[LIFECYCLE_GOOD] != want_good:
        problems.append(f"{LIFECYCLE_GOOD}'s journal walk {walk[LIFECYCLE_GOOD]}")
    if walk[LIFECYCLE_BREACH] != want_breach:
        problems.append(f"{LIFECYCLE_BREACH}'s journal walk {walk[LIFECYCLE_BREACH]}")
    if events[LIFECYCLE_GOOD].count("awaiting_approval") != 1 or \
            events[LIFECYCLE_GOOD].count("approved") != 1:
        problems.append(f"{LIFECYCLE_GOOD}'s journal events {events[LIFECYCLE_GOOD]}")
    polled = [s for s, _ in seen[LIFECYCLE_GOOD]]
    order = [s for s in LIFECYCLE_WALK if s in polled]
    if sorted(set(polled), key=LIFECYCLE_WALK.index) != order or \
            not {"analyzing", "shadowing", "promoted"} <= set(polled):
        problems.append(f"/debug/lifecycle walk of {LIFECYCLE_GOOD}: {seen[LIFECYCLE_GOOD]}")
    want_ev = {"analyzing": ["verify"], "shadowing": ["analyze", "shadow", "verify"],
               "promoting": ["analyze", "shadow", "verify"],
               "promoted": ["analyze", "shadow", "verify"]}
    for stage, keys in seen[LIFECYCLE_GOOD]:
        if stage in want_ev and not set(want_ev[stage]) - {"shadow"} <= set(keys):
            problems.append(f"/debug/lifecycle at {stage}: evidence {keys}")
    if g["stage"] != "promoted" or sorted(ev) != ["analyze", "shadow", "verify"]:
        problems.append(f"{LIFECYCLE_GOOD} final: {g['stage']}, evidence {sorted(ev)}")
    if b["stage"] != "rolled_back" or b.get("halt", {}).get("gate") != "lowerability" or \
            b["halt"].get("stage") != "verifying":
        problems.append(f"{LIFECYCLE_BREACH} final: {json.dumps(b)[:600]}")
    if an.get("oracle_disagreements") != 0 or an.get("out_of_intent_flips") != 0:
        problems.append(f"analyze evidence {json.dumps(an)[:600]}")
    if ev["shadow"]["samples"] < LIFECYCLE_MIN_SAMPLES or ev["shadow"]["diffs"]:
        problems.append(f"shadow evidence {ev['shadow']}")
    for tenant, code in ((LIFECYCLE_GOOD, 5), (LIFECYCLE_BREACH, 7)):
        line = f'cedar_lifecycle_stage{{tenant="{tenant}"}} {code}'
        if line not in text:
            problems.append(f"/metrics lacks {line}")
    with open(audit) as f:
        arecs = [json.loads(ln) for ln in f if ln.strip()]
    staged = [r for r in arecs if r.get("kind") == "rollout" and r.get("event") == "staged"]
    if [r.get("description") for r in staged] != [f"lifecycle:{LIFECYCLE_GOOD}"]:
        problems.append(f"rollout stages in the audit log: {staged}")
    ts = {(r.get("tenant"), r.get("to")): r["ts"] for r in arecs
          if r.get("kind") == "lifecycle" and r.get("event") == "transition"}
    tick_s = ts[(LIFECYCLE_GOOD, "shadowing")] - ts[(LIFECYCLE_GOOD, "analyzing")]
    staged_ts = staged[0]["ts"] if staged else float("nan")
    rate = ((evals[-1][1] - evals[0][1]) / (evals[-1][0] - evals[0][0])
            if len(evals) > 1 and evals[-1][0] > evals[0][0] else float("nan"))

    # ---- launches: served (both engines), the shadow worker's, the
    # candidates' warm-ups
    served = {k: sum(e1[p]["engine"]["launches"][k] - e0[p]["engine"]["launches"][k]
                     for p in ("authorization", "admission")) for k in shadow_launches}
    launches = {k: served[k] + shadow_launches[k] + warm_launches[k] for k in served}
    if not shadow_launches.get("match_words_kernel"):
        problems.append(f"the candidate engines' shadow launches {shadow_launches}")
    if not all(launches.values()):
        problems.append(f"a kernel did not launch in phase 19: {launches}")
    problems += resilience_quiet("lifecycle", text)
    print(f"lifecycle walk ({card}): {LIFECYCLE_GOOD} polled "
          + " -> ".join(f"{s}{k}" for s, k in seen[LIFECYCLE_GOOD])
          + f"; journal {walk[LIFECYCLE_GOOD]} + events "
          f"{[e for e in events[LIFECYCLE_GOOD] if e != 'transition']}; {LIFECYCLE_BREACH} "
          f"{walk[LIFECYCLE_BREACH]}, halt {json.dumps(b.get('halt'))[:300]}", flush=True)
    print(f"lifecycle analyze gate at {ev['verify']['policies']} candidate policies ({card}, "
          f"host): {an.get('seconds')} s, universe {an.get('requests')} requests (exhaustive "
          f"{an.get('exhaustive')}), flips {json.dumps(an.get('flips'))}, out of intent "
          f"{an.get('out_of_intent_flips')}, oracle {an.get('oracle_sampled')} sampled / "
          f"{an.get('oracle_disagreements')} disagreements; verify "
          f"{json.dumps(ev['verify'])}", flush=True)
    print(f"lifecycle stage ({card}): the analyzing tick (the live tiers' gate, the candidate "
          f"parsed twice, the diff, the stage) {tick_s:.3f} s; from the parsed candidate, the "
          f"stage (strict gate, two candidate compiles) {staged_ts - staged_at:.3f} s and stage "
          f"to ready {t_ready_unix - staged_at:.3f} s (polled every 0.1 s; warm-up per engine "
          + json.dumps({e: {"compile_seconds": w["compile_seconds"], "warm_seconds": w["seconds"],
                            "launches": w["launches"]} for e, w in warm.items()})
          + f"); shadow {sum(diff['evaluations'].values())} evaluations, {rate:.1f} "
          f"samples a second, shed {json.dumps(diff['shed'])}, diffs "
          f"{json.dumps(diff['diffs'])}", flush=True)
    if profile is not None:
        samples, top = profile
        print(f"lifecycle profile while shadowing ({card}): {samples} samples; top stacks "
              + " | ".join(f"{k}x {' < '.join(reversed(frames))}" for k, frames in top),
              flush=True)
    print(f"lifecycle approve ({card}): POST /lifecycle/approve {approve_s * 1e3:.3f} ms, "
          f"promoted {(t_promoted - t_approve) * 1e3:.1f} ms after it (polled every 20 ms); "
          f"launches served {json.dumps(served)} + shadow {json.dumps(shadow_launches)} + "
          f"candidate warm-ups {json.dumps(warm_launches)}", flush=True)
    launches["_records"] = records
    launches["_marks"] = (t_approve, t_promoted)
    return launches


def lifecycle_oracle(args, pool, live_dir, good_dir):
    t0 = time.monotonic()
    out = interpreter_answers({"live": (f"dir-authorize:{live_dir}", pool),
                               "cand": (f"dir-authorize:{good_dir}", pool)},
                              args.policies, args.seed, piece=96)
    return out, time.monotonic() - t0


def lifecycle_flips(card, records, marks, answers, t_oracle, problems) -> None:
    """Every answer of the phase against the interpreter over the set
    live when it was served: the live set before the approval, the
    candidate after the promotion was seen, either in between."""
    t_approve, t_promoted = marks
    live, cand = answers["live"], answers["cand"]
    same = sum(a == b for a, b in zip(live, cand))
    counts = {"before": 0, "during": 0, "after": 0}
    flips = {k: 0 for k in counts}
    first_after = None
    for t_send, t_recv, i, status in records:
        got = canon({"status": status})
        if t_recv < t_approve:
            part, ok = "before", got == live[i]
        elif t_send > t_promoted:
            part, ok = "after", got == cand[i]
            if first_after is None:
                first_after = t_recv - t_approve
        else:
            part, ok = "during", got in (live[i], cand[i])
        counts[part] += 1
        if not ok:
            flips[part] += 1
            if sum(flips.values()) <= 3:
                print(f"lifecycle flip ({part}): body {i}, got {json.dumps(got)}, live "
                      f"{json.dumps(live[i])}, candidate {json.dumps(cand[i])}", flush=True)
    if sum(flips.values()):
        problems.append(f"flips vs the interpreter {flips}")
    if not counts["after"]:
        problems.append("no answer after the promotion")
    print(f"lifecycle answers ({card}): {counts} (before the approval / between it and the "
          f"promotion / after), flips vs the interpreter {flips}; the oracle's "
          f"{2 * len(live)} answers in {t_oracle:.1f} s ({same} of {len(live)} bodies answer "
          f"alike on both sets); approve to the first answer of the promoted set "
          f"{(first_after or float('nan')) * 1e3:.1f} ms", flush=True)


def lifecycle_canary(card, engine, tiers, pool, problems) -> None:
    """Phase 19 (c), the embedded canary router (--only-lifecycle): an
    in-process RolloutController over ``engine``, a clean candidate (the
    same tiers) walked up the 10 / 50 / 100 ladder and promoted, then
    rolled back; then the lifecycle-breach game day halting a second
    rollout on its canary SLO burn. Every served answer is the live
    engine's."""
    from cedar_tpu_torch.chaos import default_registry
    from cedar_tpu_torch.lifecycle import (
        TERMINAL_STAGES,
        LifecycleController,
        PolicyRolloutSpec,
        RolloutLifecycleDriver,
    )
    from cedar_tpu_torch.obs import SLOTracker
    from cedar_tpu_torch.ops import cuda_match
    from cedar_tpu_torch.rollout import RolloutController
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.server.sar import get_authorizer_attributes
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    t0 = time.monotonic()
    stores = TieredPolicyStores([MemoryStore("synth", tiers[0])])
    authz = CedarWebhookAuthorizer(stores, evaluate=engine.evaluate,
                                   evaluate_batch=engine.evaluate_batch)
    bodies = pool[:384]

    def live_eval(body):
        return authz.authorize_batch([get_authorizer_attributes(json.loads(body))])[0]

    want = [live_eval(b) for b in bodies]
    rollout = RolloutController(authz_engine=engine)
    slo = SLOTracker(availability_target=0.999)
    ctrl = LifecycleController(backoff_base_s=0.0, backoff_cap_s=0.001,
                               backoff_uniform=lambda a, b: 0.0)
    launches0 = cuda_match.launch_counts()
    try:
        for tenant, chaos in (("canary-clean", None), ("canary-breach", "lifecycle-breach")):
            driver = RolloutLifecycleDriver(tenant, rollout, slo=slo, live_eval=live_eval,
                                            warm="sync")
            spec = PolicyRolloutSpec(tenant=tenant, candidate={"tiers": tiers},
                                     shadow_min_samples=0 if chaos else 64,
                                     canary_min_decisions=24, canary_ladder=(10, 50, 100))
            if chaos:
                reg = default_registry()
                reg.configure(chaos_builtin(chaos))
                reg.arm()
            ctrl.apply(spec, driver)
            served_bad = 0
            for _ in range(60):
                stage = ctrl.tick()[tenant]
                if stage in TERMINAL_STAGES:
                    break
                if stage in ("shadowing", "canary"):
                    got = [driver.serve(b) for b in bodies]
                    served_bad += sum(g != w for g, w in zip(got, want))
                    rollout.drain(60)
            doc = ctrl.status()["tenants"][tenant]
            default_registry().reset()
            want_stage = "rolled_back" if chaos else "promoted"
            if doc["stage"] != want_stage or served_bad:
                problems.append(f"canary {tenant}: {doc['stage']}, {served_bad} served answers "
                                f"unlike the live engine's: {json.dumps(doc)[:600]}")
            if chaos and doc.get("halt", {}).get("gate") != "slo_burn":
                problems.append(f"canary {tenant} halted on {doc.get('halt')}")
            print(f"lifecycle canary router {tenant} ({card}): {doc['stage']} at rung "
                  f"{doc['rung']}, evidence {json.dumps(doc['evidence'])}"
                  + (f", halt {doc['halt']['gate']}" if doc.get("halt") else ""), flush=True)
            if not chaos:
                rollout.rollback()  # the live set serves again for the game day
    finally:
        rollout.stop()
        default_registry().reset()
    launches = {k: n - launches0.get(k, 0) for k, n in cuda_match.launch_counts().items()}
    print(f"lifecycle canary router ({card}): {time.monotonic() - t0:.1f} s, launches "
          f"{json.dumps(launches)}", flush=True)


def lifecycle_resume(card, tmp, cfg, good_dir, problems) -> None:
    """Phase 19 (c), a crash resume (--only-lifecycle): a server over a
    fresh journal walks tenant-good to shadowing and is killed (SIGKILL);
    a new server on the same journal resets what the dead one left in
    flight, restarts the rollout from pending (a ``resumed`` record) and
    walks it to shadowing again."""
    rdir = os.path.join(tmp, "resume-specs")
    os.makedirs(rdir, exist_ok=True)
    doc = {"kind": "PolicyRollout", "metadata": {"name": LIFECYCLE_GOOD},
           "spec": {"candidate": {"directory": good_dir},
                    "gates": {"shadow": {"min_samples": 10**9}},
                    "promotion": {"mode": "manual", "canary_ladder": []},
                    "stage_deadline_s": 600}}
    with open(os.path.join(rdir, "good.json"), "w") as f:
        json.dump(doc, f)
    journal = os.path.join(tmp, "resume-journal.jsonl")
    flags = ("--request-timeout-ms", "10000", "--rollout-insecure-control",
             "--lifecycle-spec-dir", rdir, "--lifecycle-journal-file", journal,
             "--lifecycle-interval-seconds", "0.5")
    t0 = time.monotonic()
    for run in ("first", "resumed"):
        srv = Webhook(cfg, tmp, f"webhook-lifecycle-{run}", 5.0, flags)
        try:
            srv.wait_ready(card)
            deadline = time.monotonic() + 300
            while True:
                st = _lifecycle_doc(srv)["tenants"][LIFECYCLE_GOOD]
                if st["stage"] == "shadowing" and _rollout_doc(srv)["state"] == "staged":
                    break
                if time.monotonic() > deadline:
                    fail(f"lifecycle resume ({run}): not shadowing within 300 s: {st}")
                time.sleep(0.1)
            if run == "resumed":
                srv.terminate()
        finally:
            srv.kill()  # the first run: a crash while shadowing
    with open(journal) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    events = [(r["event"], r.get("from"), r.get("to")) for r in recs]
    want = [("applied", None, None), ("transition", "pending", "verifying"),
            ("transition", "verifying", "shadowing"), ("resumed", "shadowing", "pending"),
            ("transition", "pending", "verifying"), ("transition", "verifying", "shadowing")]
    if events != want:
        problems.append(f"lifecycle resume journal {events}")
    print(f"lifecycle crash resume ({card}): journal {events}; two servers in "
          f"{time.monotonic() - t0:.1f} s", flush=True)


# phase 20: the multi-tenant shared plane. The JAX bench's own setting
# (bench.py --tenants): synth_tenant_corpora(1000, 10, seed=17,
# clusters=2), 10 tenants of 1,000 policies fused into 10,000; one
# directory per tenant, one file per policy (a one-policy edit then
# re-parses one object)
TENANCY_N, TENANCY_TENANTS, TENANCY_SEED = 1000, 10, 17
TENANCY_FALLBACK = "tenant-03"  # also carries the interpreter-fallback policy
TENANCY_HEADER = "tenant-00"  # a sample routed by the x-cedar-tenant header
TENANCY_HOST_TENANT, TENANCY_HOST = "tenant-09", "tenant-09.authz.example"  # and by Host
TENANCY_STANDALONE = ("tenant-00", TENANCY_FALLBACK)  # held to standalone card engines
TENANCY_EDIT = "tenant-05"  # one policy of it edited
# 128, 32, 32 and 96 until the offline toolchain's slice needed the time
TENANCY_SARS, TENANCY_REVIEWS, TENANCY_C1, TENANCY_C64 = 64, 16, 16, 48
TENANCY_SAMPLE = 16  # main bodies of the header and host tenants sent that way
TENANCY_MIN_CROSS = 32


def tenancy_dirs(root: str) -> dict:
    """Write each tenant's policies, one file per policy (the fallback
    tenant's also the interpreter-fallback policy); returns the corpora
    {tenant: SynthCorpus} the traffic is aimed with."""
    from cedar_tpu_torch.corpus.synth import _synth_sources, synth_tenant_corpora

    corpora = synth_tenant_corpora(TENANCY_N, TENANCY_TENANTS, seed=TENANCY_SEED, clusters=2)
    for tid, c in corpora.items():
        files = {f"p{i:04d}": src for i, src in
                 enumerate(_synth_sources(c.n, c.seed, c.clusters, tid)[0])}
        if tid == TENANCY_FALLBACK:
            files["fallback"] = FALLBACK_POLICY
        _write_policy_dir(os.path.join(root, tid), files)
    return corpora


def org_wide_bodies(corpus) -> list:
    """A SAR aimed at each org-wide (core-group) policy of a tenant's
    corpus: the slice that would cross-match between tenants without the
    plane's discriminators."""
    out = []
    for p in corpus.params:
        if p.cluster != -1:
            continue
        ra = {"verb": p.verbs[0] if p.verbs else "get", "group": p.group, "version": "v1",
              "resource": p.resource or "pods", "namespace": p.ns or "default"}
        out.append(json.dumps({
            "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": {"user": p.user or "org-someone", "uid": "u",
                     "groups": [p.team] if p.team else [], "resourceAttributes": ra}}).encode())
    return out


def request_many(port: int, items: list, concurrency: int):
    """Send (method, path, body, headers) items from `concurrency` client
    threads, one keep-alive connection each, nothing retried -> (wall s,
    [latency s], [(status, response document)], [client error]). Any
    status is an answer; a connection the server closes is an error."""
    lat = [0.0] * len(items)
    got = [None] * len(items)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= len(items):
                    return
                method, path, body, headers = items[i]
                t = time.perf_counter()
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                lat[i] = time.perf_counter() - t
                if resp.will_close:
                    raise RuntimeError(f"{method} {path}: HTTP {resp.status}, connection closed")
                got[i] = (resp.status, json.loads(data))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish within 600 s")
    return time.perf_counter() - t0, lat, got, errors


def post_many(port: int, items: list, concurrency: int):
    """POST (path, body, headers) items from `concurrency` client threads
    (request_many) -> (wall s, [latency s], [response document], [client
    error]); an answer other than 200 is an error."""
    wall, lat, got, errors = request_many(port, [
        ("POST", path, body, {"Content-Type": "application/json", **headers})
        for path, body, headers in items], concurrency)
    for (path, _b, _h), g in zip(items, got):
        if g is not None and g[0] != 200:
            errors.append(f"{path}: HTTP {g[0]}")
            break
    return wall, lat, [g[1] if g is not None else None for g in got], errors


def served_key(path: str, doc: dict):
    """What a served answer is held to: a SAR's status with its reason
    set, an AdmissionReview response's adm_key."""
    return adm_key(doc["response"]) if path.endswith("/v1/admit") else canon(doc)


def oracle_key(path: str, answer: dict):
    return adm_key(answer["response"]) if path.endswith("/v1/admit") else answer


def tenancy_batches(srv) -> tuple:
    """(batches, rows) of the authorization batcher so far (/metrics)."""
    text = http_get(srv.mport, "/metrics")[1].decode()
    vals = {}
    for line in text.splitlines():
        for part in ("_sum", "_count"):
            if line.startswith(f'cedar_batch_occupancy{part}{{path="authorization"}}'):
                vals[part] = float(line.rsplit(" ", 1)[1])
    return vals.get("_count", 0.0), vals.get("_sum", 0.0)


def tenancy_phase(args, card: str, parity) -> dict:
    """Phase 20 (module docstring): ten tenants' directories fused into
    one pair of card engines behind the CLI's tenant front end. Returns
    the server's kernel launches over the phase's traffic (served counts:
    warm-ups apart)."""
    import copy
    import shutil

    import torch

    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import SARFastPath
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.ops import match as plain
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.server.sar import sar_response
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
    from cedar_tpu_torch.stores.store import TieredPolicyStores
    from cedar_tpu_torch.tenancy import TenantBody, TenantRegistry, fused_tier_stores

    t_phase = time.monotonic()
    problems = []
    with tempfile.TemporaryDirectory(prefix="cedar-tenancy-") as tmp:
        root = os.path.join(tmp, "tenants")
        corpora = tenancy_dirs(root)
        tenants = list(corpora)
        tdir = {t: os.path.join(root, t) for t in tenants}
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"spec": {"stores": []}}, f)
        flags = [x for t in tenants for x in ("--tenant", f"{t}={tdir[t]}")]
        # the cache on (the default), each tenant's gate permissive; deny
        # entries outlive the phase (its check reads the neighbors' cached
        # decisions back after the edit)
        flags += ["--tenant-host", f"{TENANCY_HOST}={TENANCY_HOST_TENANT}",
                  "--validation-mode", "permissive",
                  "--request-timeout-ms", "10000", "--decision-cache-deny-ttl-seconds", "300",
                  "--profiling"]
        srv = Webhook(cfg, tmp, "webhook-tenancy", 5.0, flags, cache=True)
        try:
            # ---- the traffic: bodies distinct within each tenant (a
            # repeat would answer from the cache); the same bytes sent to
            # two tenants are two requests
            seen = {t: set() for t in tenants}

            def fresh(t, bodies):
                out = [b for b in dict.fromkeys(bodies) if b not in seen[t]]
                seen[t].update(out)
                return out

            main = {t: fresh(t, gated_bodies(corpora[t], TENANCY_SARS, seed=args.seed + 200 + i))
                    for i, t in enumerate(tenants)}
            c1 = {t: fresh(t, corpora[t].sar_bodies(TENANCY_C1, seed=args.seed + 300 + i))
                  for i, t in enumerate(tenants)}
            c64 = {t: fresh(t, corpora[t].sar_bodies(TENANCY_C64, seed=args.seed + 400 + i))
                   for i, t in enumerate(tenants)}
            reviews = {t: admission_bodies(TENANCY_REVIEWS, args.seed + 500 + i)
                       for i, t in enumerate(tenants)}
            cross = {t: fresh(t, org_wide_bodies(corpora[t])) for t in tenants}
            neighbor = {t: tenants[(i + 1) % len(tenants)] for i, t in enumerate(tenants)}

            # ---- the interpreter's answers, over each tenant's own
            # directory alone, computed while the server starts
            tasks = {}
            for t in tenants:
                sar_set = list(dict.fromkeys(main[t] + c1[t] + c64[t] + cross[t] + [
                    b for u in tenants if neighbor[u] == t for b in cross[u]]))
                tasks[(t, "sar")] = (f"dir-authorize:{tdir[t]}", sar_set)
                tasks[(t, "adm")] = (f"dir-admit:{tdir[t]}", reviews[t])
            oracle_out: dict = {}

            def run_oracle():
                t0 = time.monotonic()
                try:
                    oracle_out["answers"] = interpreter_answers(
                        tasks, args.policies, args.seed, piece=128)
                except Exception as e:  # noqa: BLE001 — reported below
                    oracle_out["error"] = repr(e)
                oracle_out["seconds"] = time.monotonic() - t0

            oracle_thread = threading.Thread(target=run_oracle)
            oracle_thread.start()

            # ---- in this process: the same ten tenants fused into a card
            # engine (from the corpora already parsed, each policy named
            # and ordered as its directory store serves it: the server's
            # plane, its positions aside), and two tenants' standalone card
            # engines over their directories
            t0 = time.monotonic()

            def as_served(t) -> list:
                out = []
                if t == TENANCY_FALLBACK:
                    out = [p for p in PolicySet.from_source(
                        FALLBACK_POLICY, "fallback.cedar").policies()]
                    out[0].policy_id = "fallback.cedar.policy0"
                for i, p in enumerate(corpora[t].policies):
                    q = copy.copy(p)
                    q.filename, q.policy_id = f"p{i:04d}.cedar", f"p{i:04d}.cedar.policy0"
                    out.append(q)
                return out

            reg = TenantRegistry()
            for t in tenants:
                reg.add_tenant(t, tiers=[PolicySet(as_served(t))])
            fused_stores = fused_tier_stores(reg)
            fused = TorchPolicyEngine(incremental=True, name="tenancy")
            fused.load(reg.fused_tiers())
            fast = SARFastPath(fused, CedarWebhookAuthorizer(
                fused_stores, evaluate_batch=fused.evaluate_batch))
            solo = {}
            for t in TENANCY_STANDALONE:
                st = TieredPolicyStores([DirectoryPolicyStore(tdir[t], start_ticker=False)])
                e = TorchPolicyEngine(name=f"solo-{t}")
                e.load([s.policy_set() for s in st])
                solo[t] = SARFastPath(e, CedarWebhookAuthorizer(
                    st, evaluate_batch=e.evaluate_batch))
            cs = fused.compiled_set
            print(f"tenancy in-process engines ({card}): fused {len(reg)} tenants, "
                  f"{sum(len(ps.policies()) for ps in reg.fused_tiers())} policies -> "
                  f"L={cs.L} R={cs.R} G={cs.n_groups} fallback={len(cs.fallback)}, tenant "
                  f"column {cs.tenant_column[0]}; standalone "
                  + ", ".join(f"{t} L={s.engine.compiled_set.L} R={s.engine.compiled_set.R}"
                              for t, s in solo.items())
                  + f"; {time.monotonic() - t0:.1f} s", flush=True)
            if not cs.fallback:
                problems.append("the fused plane carries no interpreter-fallback policy")

            # ---- kernel parity on the fused plane's own operands: native
            # codes of every tenant's main bodies, each row stamped with
            # its tenant's discriminator code
            snap = fast._current_snapshot()
            rows = [(b, t) for t in tenants for b in main[t]]
            codes, extras, _n, flags_ = snap.encoder.encode_batch([b for b, _ in rows])
            col, vocab = cs.tenant_column
            codes[:, col] = [vocab.get(("s", t), 0) for _, t in rows]
            ok = flags_ == 0
            codes, extras = fused._pad_to_bucket(codes[ok], extras[ok], cs.L)
            lit = plain.lit_matrix_codes(fused._to_device(codes), fused._to_device(extras),
                                         cs.act_rows_dev)
            plane = (cs.W_dev, cs.thresh_dev, cs.rule_group_dev, cs.rule_policy_dev,
                     cs.n_tiers, cs.has_gate)
            for B in (lit.shape[0], 128, 1):
                parity("tenancy", lit[:B].contiguous(), *plane, need_mix=False,
                       maps=cs.plane_maps)

            srv.wait_ready(card)
            # the first /readyz 200 seen once this process's set-up above
            # was done (the server took longer than that set-up on the card)
            ready_s = time.monotonic() - srv.t0
            # the oracle pool is done before any window is timed
            oracle_thread.join()
            # what one tenant store's re-read (each tenant's ticker, every
            # max(1, --reload-seconds) s) costs on this host
            probe_store = DirectoryPolicyStore(tdir[tenants[0]], start_ticker=False)
            t1 = time.perf_counter()
            for _ in range(5):
                probe_store.load_policies()
            reread_ms = (time.perf_counter() - t1) / 5 * 1e3
            print(f"tenancy store tick ({card}): {reread_ms:.3f} ms for one tenant's "
                  f"{TENANCY_N} settled files (each of the server's {TENANCY_TENANTS} tenant "
                  "stores ticks every 5 s, the CLI's --reload-seconds default)", flush=True)

            # ---- c=1, in this process: the fused engine against the
            # standalone ones, one body at a time (the library call)
            lib = {}
            for t, s in solo.items():
                for label, call in (("fused", lambda b, t=t: fast.authorize_raw(
                        [TenantBody(b, t)])), ("standalone", lambda b, s=s: s.authorize_raw([b]))):
                    lat = []
                    for b in c1[t]:
                        t1 = time.perf_counter()
                        call(b)
                        lat.append(time.perf_counter() - t1)
                    lib[(t, label)] = (pct(lat, 50) * 1e3, pct(lat, 99) * 1e3)
            print(f"tenancy c=1 library call, ms p50 / p99 ({card}): " + "; ".join(
                f"{t} fused {lib[(t, 'fused')][0]:.3f} / {lib[(t, 'fused')][1]:.3f}, standalone "
                f"{lib[(t, 'standalone')][0]:.3f} / {lib[(t, 'standalone')][1]:.3f}"
                for t in solo), flush=True)

            e0 = srv.debug_engine()
            launches0 = {p: dict(e0[p]["engine"]["launches"]) for p in ("authorization", "admission")}
            # ---- c=1 over HTTP, per tenant, fresh bodies (misses)
            c1_items = {t: [(f"/t/{t}/v1/authorize", b, {}) for b in c1[t]] for t in tenants}
            c1_lat, c1_docs = {}, {}
            for t in tenants:
                _w, lat, got, errs = post_many(srv.port, c1_items[t], 1)
                if errs:
                    fail(f"tenancy c=1 {t}: client errors {errs[:3]}")
                c1_lat[t], c1_docs[t] = lat, got
            # ---- mixed c=64, tenants interleaved, fresh bodies
            mix = [(f"/t/{t}/v1/authorize", c64[t][k], {}) for k in range(TENANCY_C64)
                   for t in tenants if k < len(c64[t])]
            b0 = tenancy_batches(srv)
            wall64, lat64, docs64, errs = post_many(srv.port, mix, 64)
            b1 = tenancy_batches(srv)
            if errs:
                fail(f"tenancy c=64: client errors {errs[:3]}")
            mean_batch = (b1[1] - b0[1]) / max(b1[0] - b0[0], 1)

            # ---- the main traffic from 8 clients, tenants interleaved:
            # every tenant's SARs (the header tenant's first ones through
            # the header, the host tenant's through Host) and reviews, and
            # the org-wide bodies sent to their own tenant and a neighbor
            def sar_route(t, k):
                if t == TENANCY_HEADER and k < TENANCY_SAMPLE:
                    return "/v1/authorize", {"x-cedar-tenant": t}
                if t == TENANCY_HOST_TENANT and k < TENANCY_SAMPLE:
                    return "/v1/authorize", {"Host": TENANCY_HOST}
                return f"/t/{t}/v1/authorize", {}

            items, meta = [], []  # meta: (tenant, kind, index)
            depth = max(max(len(v) for v in main.values()), TENANCY_REVIEWS,
                        max(len(v) for v in cross.values()))
            for k in range(depth):
                for t in tenants:
                    if k < len(main[t]):
                        path, hdrs = sar_route(t, k)
                        items.append((path, main[t][k], hdrs))
                        meta.append((t, "main", k))
                    if k < TENANCY_REVIEWS:
                        items.append((f"/t/{t}/v1/admit", reviews[t][k], {}))
                        meta.append((t, "adm", k))
                    if k < len(cross[t]):
                        for u in (t, neighbor[t]):
                            items.append((f"/t/{u}/v1/authorize", cross[t][k], {}))
                            meta.append((u, "cross", (t, k)))
            # one whole-process profile of the server inside the window
            prof: dict = {}
            prof_thread = threading.Thread(
                target=lambda: (time.sleep(2.0), prof.update(top=pprof_top(srv.port, 4, busy=True))))
            text0 = http_get(srv.mport, "/metrics")[1].decode()
            prof_thread.start()
            wall8, lat8, docs8, errs = post_many(srv.port, items, 8)
            prof_thread.join()
            text1 = http_get(srv.mport, "/metrics")[1].decode()
            if errs:
                fail(f"tenancy main traffic: client errors {errs[:3]}")
            st0, st1 = stage_totals(text0, "authorization"), stage_totals(text1, "authorization")
            stage_ms = {k: round((st1[k][0] - st0.get(k, [0, 0])[0]) * 1e3
                                 / max(st1[k][1] - st0.get(k, [0, 0])[1], 1), 3) for k in st1}
            samples, top = prof.get("top", (0, []))
            print(f"tenancy 8 clients ({card}): {len(items) / wall8:.1f} requests/s, p50 "
                  f"{pct(lat8, 50) * 1e3:.3f} ms, p99 {pct(lat8, 99) * 1e3:.3f} ms; authorization "
                  f"stage means per batch, ms {json.dumps(stage_ms)}; server profile "
                  f"{samples} samples, top busy stacks "
                  + " | ".join(f"{k}x {' < '.join(reversed(fr))}" for k, fr in top), flush=True)

            # ---- refusals: they answer before evaluation, launching nothing
            e1 = srv.debug_engine()
            refused = [("/t/nobody/v1/authorize", b"{}", {}, "unknown"),
                       ("/v1/authorize", main[tenants[1]][0], {}, "missing"),
                       ("/t/nobody/v1/admit", reviews[tenants[1]][0], {}, "unknown"),
                       ("/v1/admit", reviews[tenants[1]][0], {}, "missing")]
            _w, _l, rdocs, errs = post_many(srv.port, [r[:3] for r in refused], 1)
            e2 = srv.debug_engine()
            if errs:
                fail(f"tenancy refusals: client errors {errs[:3]}")
            for (path, _b, _h, why), doc in zip(refused, rdocs):
                msg = ("unknown tenant" if why == "unknown" else "no tenant resolved")
                if path.endswith("/admit"):
                    r = doc["response"]
                    good = not r["allowed"] and r["status"]["code"] == 403 and \
                        r["status"]["message"] == f"tenant rejected: {msg}"
                else:
                    good = doc["status"].get("evaluationError") == f"tenant rejected: {msg}"
                if not good:
                    problems.append(f"refusal {path}: {json.dumps(doc)[:300]}")
            for p in ("authorization", "admission"):
                if e2[p]["engine"]["launches"] != e1[p]["engine"]["launches"]:
                    problems.append(f"a refusal launched on {p}: {e1[p]['engine']['launches']} "
                                    f"-> {e2[p]['engine']['launches']}")

            # ---- every answer against the interpreter over its tenant
            if "error" in oracle_out:
                fail(f"tenancy oracle: {oracle_out['error']}")
            ans = oracle_out["answers"]
            want_sar = {t: dict(zip(tasks[(t, "sar")][1], ans[(t, "sar")])) for t in tenants}
            want_adm = {t: ans[(t, "adm")] for t in tenants}
            flips = 0

            def check(label, path, doc, want):
                nonlocal flips
                if served_key(path, doc) != oracle_key(path, want):
                    flips += 1
                    if flips <= 3:
                        print(f"tenancy flip {label} {path}: got {json.dumps(doc)[:400]}, want "
                              f"{json.dumps(want)[:400]}", flush=True)

            for t in tenants:
                for (path, b, _h), doc in zip(c1_items[t], c1_docs[t]):
                    check("c1", path, doc, want_sar[t][b])
            for (path, b, _h), doc in zip(mix, docs64):
                check("c64", path, doc, want_sar[path.split("/")[2]][b])
            differ = 0
            cross_got: dict = {}
            for (path, b, _h), (t, kind, k), doc in zip(items, meta, docs8):
                want = want_adm[t][k] if kind == "adm" else want_sar[t][b]
                check(kind, path, doc, want)
                if kind == "cross":
                    cross_got.setdefault(k, []).append(canon(doc))
            differ = sum(1 for pair in cross_got.values() if len(pair) == 2 and pair[0] != pair[1])
            n_checked = sum(len(v) for v in c1_docs.values()) + len(docs64) + len(docs8)
            print(f"tenancy answers ({card}): {n_checked} against the interpreter over each "
                  f"tenant's own directory ({oracle_out['seconds']:.1f} s in the oracle pool), "
                  f"flips {flips}; org-wide bodies {len(cross_got)}, answered differently by "
                  f"their tenant and its neighbor {differ}", flush=True)
            if flips:
                problems.append(f"{flips} answers differ from the interpreter's")
            if differ < TENANCY_MIN_CROSS:
                problems.append(f"only {differ} org-wide bodies answered differently per tenant "
                                f"(want at least {TENANCY_MIN_CROSS})")

            # ---- the standalone card engines answer alike
            for t, s in solo.items():
                got = [canon(doc) for (tt, kind, _k), doc in zip(meta, docs8)
                       if tt == t and kind == "main"]
                bodies_t = [b for (_p, b, _h), (tt, kind, _k) in zip(items, meta)
                            if tt == t and kind == "main"]
                alone = [canon(sar_response(*r)) for r in s.authorize_raw(bodies_t)]
                n_diff = sum(a != b for a, b in zip(got, alone))
                print(f"tenancy {t}: {len(got)} served answers vs its standalone card engine, "
                      f"{n_diff} differ; routing {json.dumps(s.routing)}", flush=True)
                if n_diff:
                    problems.append(f"{t}: {n_diff} answers differ from its standalone engine")

            # ---- one policy of one tenant edited: a body it decides alone
            pick = None
            for b in main[TENANCY_EDIT]:
                st = want_sar[TENANCY_EDIT][b]
                if isinstance(st["reason"], list) and len(st["reason"]) == 1:
                    pol = json.loads(st["reason"][0])["policy"]
                    if pol.startswith("p") and pol.endswith(".cedar.policy0"):
                        pick = pol[:-len(".policy0")]
                        break
            if pick is None:
                fail(f"tenancy: no body of {TENANCY_EDIT} decided by one policy")
            v1 = os.path.join(tmp, "edit-v1", TENANCY_EDIT)
            shutil.copytree(tdir[TENANCY_EDIT], v1)
            with open(os.path.join(v1, pick)) as f:
                src = f.read()
            flipped = ("forbid " + src[len("permit "):] if src.startswith("permit ")
                       else "permit " + src[len("forbid "):])
            with open(os.path.join(v1, pick), "w") as f:
                f.write(flipped)
            resend = [(f"/t/{t}/v1/authorize", b, {}) for t in tenants for b in main[t]]
            edit_bodies = main[TENANCY_EDIT]
            v1_out = interpreter_answers({"v1": (f"dir-authorize:{v1}", edit_bodies)},
                                         args.policies, args.seed, piece=32)
            want_v1 = dict(zip(edit_bodies, v1_out["v1"]))
            changed = sum(want_v1[b] != want_sar[TENANCY_EDIT][b] for b in edit_bodies)
            # the neighbors' decided answers, each a cached entry now
            decided = [it for it in resend if not it[0].startswith(f"/t/{TENANCY_EDIT}/")
                       and (want_sar[it[0].split("/")[2]][it[1]]["allowed"]
                            or want_sar[it[0].split("/")[2]][it[1]]["denied"])]
            gens = {p: e2[p]["engine"]["load_generation"] for p in ("authorization", "admission")}
            tmpf = os.path.join(tdir[TENANCY_EDIT], ".edit.tmp")
            with open(tmpf, "w") as f:
                f.write(flipped)
            t_event = time.time()
            os.rename(tmpf, os.path.join(tdir[TENANCY_EDIT], pick))
            deadline = time.monotonic() + 120
            while True:
                e3 = srv.debug_engine()
                if all(e3[p]["engine"]["load_generation"] > gens[p] for p in gens):
                    break
                if time.monotonic() > deadline:
                    fail(f"tenancy: the edit did not reach both engines in 120 s:\n{srv.log()}")
                time.sleep(0.05)
            for p in ("authorization", "admission"):
                last, sh = e3[p]["engine"]["last_load"], e3[p]["engine"]["shards"]
                roll = sh.get("tenants", {})
                print(f"tenancy edit {p} engine ({card}): {pick} of {TENANCY_EDIT} flipped, "
                      f"event to swap {last['published_unix'] - t_event:.3f} s, "
                      f"{last['compile_scope']} compile, {last['dirty_shards']} of "
                      f"{last['shards']} shards dirty {sh['dirty']}, compile seconds "
                      f"{json.dumps(last['compile_seconds'])}; rollup dirty "
                      f"{json.dumps({t: r['dirty'] for t, r in roll.items() if r['dirty']})}",
                      flush=True)
                if last["dirty_shards"] != 1 or len(sh["dirty"]) != 1 or \
                        not sh["dirty"][0].startswith(f"{TENANCY_EDIT}/"):
                    problems.append(f"edit {p}: dirty {sh['dirty']} ({last['dirty_shards']})")
                if {t: r["dirty"] for t, r in roll.items()} != \
                        {t: int(t == TENANCY_EDIT) for t in tenants}:
                    problems.append(f"edit {p}: rollup {json.dumps(roll)}")
            c0 = json.loads(http_get(srv.mport, "/debug/cache")[1])["authorization"]
            _w, _l, dgot, errs = post_many(srv.port, decided, 8)
            c1c = json.loads(http_get(srv.mport, "/debug/cache")[1])["authorization"]
            # then every other SAR of the main traffic once
            sent_again = set((p, b) for p, b, _h in decided)
            resend = [it for it in resend if (it[0], it[1]) not in sent_again]
            _w, _l, rgot, errs2 = post_many(srv.port, resend, 8)
            if errs or errs2:
                fail(f"tenancy after the edit: client errors {(errs + errs2)[:3]}")
            hits = c1c["hits"] - c0["hits"]
            stale = 0
            for (path, b, _h), doc in zip(decided + resend, dgot + rgot):
                t = path.split("/")[2]
                want = want_v1[b] if t == TENANCY_EDIT else want_sar[t][b]
                if canon(doc) != want:
                    stale += 1
                    if stale <= 3:
                        print(f"tenancy stale {path}: got {json.dumps(doc)[:300]}", flush=True)
            print(f"tenancy after the edit ({card}): {changed} of {len(edit_bodies)} "
                  f"{TENANCY_EDIT} answers change; the neighbors' {len(decided)} decided "
                  f"entries: {hits} cache hits; {len(decided) + len(resend)} answers, "
                  f"{stale} stale", flush=True)
            if hits != len(decided):
                problems.append(f"only {hits} of the neighbors' {len(decided)} decided "
                                "entries survived the edit")
            if stale:
                problems.append(f"{stale} stale answers after the edit")
            if not changed:
                problems.append("the edit changed no answer of the edited tenant")

            # ---- launches, metrics, memory
            e4 = srv.debug_engine()
            # the counts are process-wide: every engine's entry shows them
            launches = {k: e4["authorization"]["engine"]["launches"][k]
                        - launches0["authorization"][k] for k in launches0["authorization"]}
            if not all(launches.values()):
                problems.append(f"a kernel did not launch in phase 20: {launches}")
            text = http_get(srv.mport, "/metrics")[1].decode()
            rejected = {r: metric_total(text, f'cedar_tenant_rejected_total{{reason="{r}"}}')
                        for r in ("unknown", "missing")}
            if rejected != {"unknown": 2.0, "missing": 2.0}:
                problems.append(f"cedar_tenant_rejected_total {rejected}")
            per_tenant = {t: sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                                 if line.startswith(f'cedar_tenant_requests_total{{tenant="{t}",'))
                          for t in tenants}
            sent = {t: 0 for t in tenants}
            for path, _b, hdrs in [it for t in tenants for it in c1_items[t]] + mix + items \
                    + decided + resend:
                t = path.split("/")[2] if path.startswith("/t/") else (
                    hdrs.get("x-cedar-tenant") or TENANCY_HOST_TENANT)
                sent[t] += 1
            if per_tenant != {t: float(n) for t, n in sent.items()}:
                problems.append(f"cedar_tenant_requests_total {per_tenant}, sent {sent}")
            problems += resilience_quiet("tenancy", text)
            dm = e4["authorization"]["engine"].get("device_memory", {})
            tdoc = json.loads(http_get(srv.mport, "/debug/tenancy")[1])
            c1_all = [x for v in c1_lat.values() for x in v]
            print(f"tenancy server ({card}): ready in {ready_s:.1f} s; c=1 p50 / p99 ms per "
                  "tenant " + ", ".join(f"{t} {pct(c1_lat[t], 50) * 1e3:.3f} / "
                                        f"{pct(c1_lat[t], 99) * 1e3:.3f}" for t in tenants)
                  + f" (all {pct(c1_all, 50) * 1e3:.3f} / {pct(c1_all, 99) * 1e3:.3f}); mixed "
                  f"c=64 {len(mix) / wall64:.1f} requests/s, p99 {pct(lat64, 99) * 1e3:.3f} ms, "
                  f"mean batch {mean_batch:.2f}; 8 clients {len(items) / wall8:.1f} requests/s "
                  f"over {len(items)}; launches {json.dumps(launches)}; rejected "
                  f"{json.dumps(rejected)}; /debug/tenancy {len(tdoc['registry']['per_tenant'])} "
                  f"tenants, resolver {json.dumps(tdoc['resolver'])[:200]}", flush=True)
            print(f"tenancy card memory ({card}): fused plane {e4['authorization']['engine']['device_bytes'] / 2**20:.1f} "
                  f"MiB per engine; the server's allocator allocated "
                  f"{dm.get('allocated', 0) / 2**20:.1f} MiB, peak "
                  f"{dm.get('peak_allocated', 0) / 2**20:.1f} MiB, reserved "
                  f"{dm.get('reserved', 0) / 2**20:.1f} MiB; nvidia-smi "
                  f"{gpu_memory_mib(srv.proc.pid)} MiB", flush=True)
            took, rss = srv.terminate()
            print(f"tenancy webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()
        del fast, fused, solo
        torch.cuda.empty_cache()
    if problems:
        fail("tenancy: " + "; ".join(problems))
    print(f"tenancy phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


# ---- phase 21: the PDP front end. One policy file spanning the three
# vocabularies of the JAX bench's mesh scenario (bench.py
# run_mesh_traffic_scenario): k8s resource permits, ext_authz permits
# (http:<method> over NonResourceURL paths) and AVP-style permits
# (avp:<action>), in shares 34 / 33 / 33, every policy distinct; plus an
# interpreter-fallback policy in the http:post vocabulary (its rows take
# the gated lane and match_groups_kernel) and one that reads a mapped
# context header (pdp:header:<name> of a declared context_headers entry)
PDP_K8S_VERBS = ("get", "list", "watch", "create")
PDP_K8S_RESOURCES = ("pods", "services", "secrets", "configmaps")
PDP_METHODS = ("get", "post", "put", "delete")
PDP_AVP_ACTIONS = ("view", "edit", "share", "comment")
PDP_HEADER = "x-tenant-tier"
PDP_HEADER_PATH = "/api/tiers/gold"
PDP_GATED_PATH = "/api/widgets"
PDP_FALLBACK_POLICY = (
    'permit (principal in k8s::Group::"joiners", '
    'action == k8s::Action::"http:post",\n'
    "        resource is k8s::NonResourceURL)\n"
    "  when { "
    + " && ".join(
        f'(resource.path == "{PDP_GATED_PATH}" || principal.name == "10.0.0.1")'
        for _ in range(12)
    )
    + " };\n"
)
PDP_HEADER_POLICY = (
    'permit (principal, action == k8s::Action::"http:put", resource is k8s::NonResourceURL)\n'
    f'  when {{ resource.path == "{PDP_HEADER_PATH}" && principal.extra.contains('
    f'{{"key": "pdp:header:{PDP_HEADER}", "values": ["gold"]}}) }};\n'
)


class MeshCorpus:
    """The phase's populations and policy source at `n` policies (the 10k
    north-star size in the smoke, a few hundred in the CPU tests), made
    from `seed`; draws are Zipf(1.1) over the principal pools, as the JAX
    bench's mesh scenario draws them, each a pure function of (stream,
    index)."""

    def __init__(self, n: int, seed: int):
        import math

        self.seed = seed
        n_k8s, n_http = round(0.34 * n), round(0.33 * n)
        n_avp = n - n_k8s - n_http
        # pools large enough that the sampled combinations are distinct
        # and about four in five of them are policies
        self.k8s_users = [f"controller-{i}" for i in range(
            max(2, math.ceil(n_k8s * 1.25 / (len(PDP_K8S_VERBS) * len(PDP_K8S_RESOURCES)))))]
        side = max(4, math.ceil(math.sqrt(n_http * 1.25 / len(PDP_METHODS))))
        self.mesh_users = [f"user-{i}" for i in range(side)]
        self.mesh_paths = [f"/api/items/{i}" for i in range(side)]
        side = max(4, math.ceil(math.sqrt(n_avp * 1.25 / len(PDP_AVP_ACTIONS))))
        self.app_users = [f"App::User::u{i}" for i in range(side)]
        self.docs = [f"docs/d{i}" for i in range(side)]
        rng = np.random.default_rng(seed)
        pols = []

        def sample(dims, k):
            total = int(np.prod([len(d) for d in dims]))
            for flat in rng.choice(total, size=k, replace=False):
                out = []
                for d in reversed(dims):
                    flat, j = divmod(int(flat), len(d))
                    out.append(d[j])
                yield tuple(reversed(out))

        for user, verb, res in sample((self.k8s_users, PDP_K8S_VERBS, PDP_K8S_RESOURCES), n_k8s):
            pols.append(f'permit (principal, action == k8s::Action::"{verb}", resource is '
                        f'k8s::Resource) when {{ principal.name == "{user}" && '
                        f'resource.resource == "{res}" }};')
        for user, method, path in sample((self.mesh_users, PDP_METHODS, self.mesh_paths), n_http):
            pols.append(f'permit (principal, action == k8s::Action::"http:{method}", resource is '
                        f'k8s::NonResourceURL) when {{ principal.name == "{user}" && '
                        f'resource.path == "{path}" }};')
        for user, action, doc in sample((self.app_users, PDP_AVP_ACTIONS, self.docs), n_avp):
            pols.append(f'permit (principal, action == k8s::Action::"avp:{action}", resource is '
                        f'k8s::NonResourceURL) when {{ principal.name == "{user}" && '
                        f'resource.path == "/{doc}" }};')
        self.n = len(pols) + 2
        self.source = "\n".join(pols) + "\n" + PDP_FALLBACK_POLICY + PDP_HEADER_POLICY
        self._cum = {}

    def _zipf(self, pool: list, stream: str, i: int):
        from bisect import bisect_left

        cum = self._cum.get(id(pool))
        if cum is None:
            cum = list(np.cumsum([1.0 / (r + 1) ** 1.1 for r in range(len(pool))]))
            self._cum[id(pool)] = cum
        x = random.Random(f"mesh:{self.seed}:{stream}:{i}").random() * cum[-1]
        return pool[min(len(pool) - 1, bisect_left(cum, x))]

    def sar(self, i: int, stream: str = "sar") -> bytes:
        """A kubelet- or controller-style SAR of the k8s vocabulary; one in
        32 from a kubelet (system:node:..., the ingress gate's high
        class)."""
        r = random.Random(f"mesh:{self.seed}:{stream}:{i}")
        user = (f"system:node:node-{i % 7}" if i % 32 == 5
                else self._zipf(self.k8s_users, stream + "-u", i))
        return json.dumps({
            "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": {"user": user, "uid": "u", "groups": [],
                     "resourceAttributes": {"verb": r.choice(PDP_K8S_VERBS), "version": "v1",
                                            "resource": r.choice(PDP_K8S_RESOURCES),
                                            "namespace": "default"}}}).encode()

    def check(self, i: int, stream: str = "ext") -> tuple:
        """One ext_authz check (method, path, headers): mostly a mesh
        user's request; one in 16 a joiners' POST (the gated lane), one in
        16 a PUT of the header policy's path with its header, one in 32
        from a principal named like a kubelet."""
        r = random.Random(f"mesh:{self.seed}:{stream}:{i}")
        user = self._zipf(self.mesh_users, stream + "-u", i)
        headers = {"x-forwarded-user": user, "host": "mesh.local"}
        method, path = r.choice(PDP_METHODS).upper(), r.choice(self.mesh_paths)
        if i % 16 == 3:
            method, path = "POST", r.choice([PDP_GATED_PATH, path])
            headers.update({"x-forwarded-user": f"jo-{i % 5}", "x-forwarded-groups": "joiners"})
        elif i % 16 == 11:
            method, path = "PUT", PDP_HEADER_PATH
            headers[PDP_HEADER] = r.choice(["gold", "silver"])
        elif i % 32 == 7:
            headers["x-forwarded-user"] = f"system:node:node-{i % 7}"
        return method, path, headers

    def tuples(self, i: int, k: int, stream: str = "batch") -> list:
        """k AVP-style tuples of one batch body, each with a context value
        of its own (as the JAX scenario's)."""
        r = random.Random(f"mesh:{self.seed}:{stream}:{i}")
        return [{"principal": self._zipf(self.app_users, f"{stream}-u:{i}", j),
                 "action": r.choice(PDP_AVP_ACTIONS), "resource": r.choice(self.docs),
                 "context": {"request": f"{stream}{i}-{j}"}} for j in range(k)]


PDP_C1 = 64  # fresh ext_authz checks, then fresh SARs, at c=1
PDP_MIX = 2048  # SARs and checks of the mixed window, each (4096 until
# the offline toolchain's slice needed the time)
PDP_MIX_CLIENTS = 32  # webhook clients and ext_authz clients, each
# PDP_BATCHES 128 until the offline toolchain's slice needed the time
PDP_BATCHES, PDP_TUPLES, PDP_BATCH_CLIENTS = 64, 32, 4
PDP_CAP = 64  # the schema's batch_max_tuples
PDP_SCHEMA = {"context_headers": [PDP_HEADER], "batch_max_tuples": PDP_CAP}
JSON_HEADERS = {"Content-Type": "application/json"}


def _reason_key(reason: str):
    """A rendered reason with its reason list as a set (canon's form)."""
    if reason.startswith("{"):
        return sorted(json.dumps(r, sort_keys=True) for r in json.loads(reason).get("reasons", []))
    return reason


def check_key(status: int, doc: dict) -> tuple:
    """What a served ext_authz answer is held to."""
    return status, doc["decision"], _reason_key(doc.get("reason") or ""), doc.get("error")


def oracle_check_key(st: dict) -> tuple:
    """The ext_authz answer the fail-posture matrix gives the oracle's
    canon SAR status (the oracle never errs)."""
    return (200, "allow", st["reason"], None) if st["allowed"] else (403, "deny", st["reason"], None)


def item_key(item: dict) -> tuple:
    """What a served batch item is held to."""
    return (item["decision"], sorted(p["policyId"] for p in item.get("determiningPolicies", [])),
            _reason_key(item.get("reason") or ""), item.get("errors"))


def oracle_item_key(st: dict) -> tuple:
    decision = "ALLOW" if st["allowed"] else "DENY" if st.get("denied") else "NO_OPINION"
    policies = sorted(json.loads(r)["policy"] for r in st["reason"]) if st["reason"] else []
    return decision, policies, st["reason"], None


def pdp_phase(args, card: str) -> dict:
    """Phase 21 (module docstring): the PDP front end on the CLI's server,
    SAR, ext_authz and batch-authorize traffic on one pair of card
    engines. Returns the server's kernel launches over the phase's traffic
    (served counts: warm-ups apart)."""
    from cedar_tpu_torch.load.admission import PRIORITY_HIGH, classify
    from cedar_tpu_torch.pdp import PdpBody, PdpConfig
    from cedar_tpu_torch.pdp.extauthz import check_body
    from cedar_tpu_torch.pdp.mapper import PROTOCOL_BATCH, batch_tuple_to_sar, encode_pdp_body

    t_phase = time.monotonic()
    problems = []
    pcfg = PdpConfig.from_dict(PDP_SCHEMA)
    mesh = MeshCorpus(args.policies, seed=args.seed + 21)
    with tempfile.TemporaryDirectory(prefix="cedar-pdp-") as tmp:
        pdir = _write_policy_dir(os.path.join(tmp, "policies"), {"mesh": mesh.source})
        schema = os.path.join(tmp, "pdp-schema.json")
        with open(schema, "w") as f:
            json.dump(PDP_SCHEMA, f)
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"spec": {"stores": [{"type": "directory",
                                            "directoryStore": {"path": pdir}}]}}, f)
        audit = os.path.join(tmp, "audit.jsonl")
        pdp_port = free_port()
        srv = Webhook(cfg, tmp, "webhook-pdp", 5.0, [
            "--validation-mode", "permissive", "--request-timeout-ms", "10000",
            "--pdp-listen", f"127.0.0.1:{pdp_port}", "--pdp-schema", schema,
            "--audit-log-file", audit], cache=True)
        try:
            # ---- the traffic, made while the server starts
            def fresh(make, n, stream, key=lambda x: x):
                out, seen = [], set()
                i = 0
                while len(out) < n:
                    x = make(i, stream)
                    i += 1
                    if key(x) not in seen:
                        seen.add(key(x))
                        out.append(x)
                return out

            def mapped(check):
                return check_body(*check, pcfg)

            c1_checks = fresh(mesh.check, PDP_C1, "c1-ext", lambda c: bytes(mapped(c)))
            c1_sars = fresh(mesh.sar, PDP_C1, "c1-sar")
            mix_sars = [mesh.sar(i, "mix-sar") for i in range(PDP_MIX)]
            mix_checks = [mesh.check(i, "mix-ext") for i in range(PDP_MIX)]
            mix_batches = [mesh.tuples(i, PDP_TUPLES, "mix-batch") for i in range(PDP_BATCHES)]
            posture_tuples = mesh.tuples(0, 8, "posture")
            posture_tuples[3] = {"principal": "", "action": "view", "resource": "docs/d0"}
            sent_checks = set(bytes(mapped(c)) for c in c1_checks + mix_checks)
            twin = next(c for c in (mesh.check(i, "twin") for i in range(10**6))
                        if bytes(mapped(c)) not in sent_checks)
            twin_sar = bytes(mapped(twin))

            # ---- the interpreter's answer of every distinct body, in the
            # oracle pool beside the server's start-up
            ext_bodies = {bytes(mapped(c)): mapped(c) for c in c1_checks + mix_checks + [twin]}
            tup_bodies = {}
            for tuples in mix_batches + [posture_tuples]:
                for t in tuples:
                    if t["principal"]:
                        b = encode_pdp_body(batch_tuple_to_sar(t, pcfg), PROTOCOL_BATCH, pcfg)
                        tup_bodies[bytes(b)] = b
            sar_set = list(dict.fromkeys(c1_sars + mix_sars + [twin_sar]))
            tasks = {"sar": (f"pdp:{pdir}", [("", b) for b in sar_set]),
                     "extauthz": (f"pdp:{pdir}", [("extauthz", b) for b in ext_bodies]),
                     "batch": (f"pdp:{pdir}", [("batch", b) for b in tup_bodies])}
            oracle_out: dict = {}

            def run_oracle():
                t0 = time.monotonic()
                try:
                    oracle_out["answers"] = interpreter_answers(
                        tasks, args.policies, args.seed, piece=256)
                except Exception as e:  # noqa: BLE001 — reported below
                    oracle_out["error"] = repr(e)
                oracle_out["seconds"] = time.monotonic() - t0

            oracle_thread = threading.Thread(target=run_oracle)
            oracle_thread.start()
            srv.wait_ready(card)
            ready_s = time.monotonic() - srv.t0
            oracle_thread.join()
            if "error" in oracle_out:
                fail(f"pdp oracle: {oracle_out['error']}")
            want = {}
            for label, (_name, items) in tasks.items():
                want.update(zip((b for _p, b in items), oracle_out["answers"][label]))
            flips = 0
            n_checked = 0

            def held(label, got, expect):
                nonlocal flips, n_checked
                n_checked += 1
                if got != expect:
                    flips += 1
                    if flips <= 3:
                        print(f"pdp flip {label}: got {json.dumps(got)[:400]}, want "
                              f"{json.dumps(expect)[:400]}", flush=True)

            def hold_checks(label, checks, answers):
                for c, (status, doc) in zip(checks, answers):
                    held(label, check_key(status, doc), oracle_check_key(want[bytes(mapped(c))]))

            def hold_batches(label, batches, answers):
                for tuples, (status, doc) in zip(batches, answers):
                    if status != 200 or len(doc["responses"]) != len(tuples):
                        problems.append(f"{label}: HTTP {status} {json.dumps(doc)[:200]}")
                        continue
                    for t, item in zip(tuples, doc["responses"]):
                        if not t["principal"]:
                            ok = item["decision"] == "DENY" and item["errors"][0].startswith(
                                "unmappable tuple:")
                            held(label + " malformed tuple", ok, True)
                            continue
                        b = encode_pdp_body(batch_tuple_to_sar(t, pcfg), PROTOCOL_BATCH, pcfg)
                        held(label, item_key(item), oracle_item_key(want[bytes(b)]))

            def hold_sars(label, bodies, answers):
                for b, (status, doc) in zip(bodies, answers):
                    held(label, (status, canon(doc)), (200, want[b]))

            def launches_now():
                # process-wide counts: every engine's entry shows the same
                return dict(srv.debug_engine()["authorization"]["engine"]["launches"])

            def delta(a, b):
                return {k: b[k] - a[k] for k in a}

            l0 = launches_now()
            text0 = http_get(srv.mport, "/metrics")[1].decode()
            # ---- 1. the fail postures
            batch_path = "/v1/batch-authorize"
            over_cap = json.dumps({"requests": mesh.tuples(1, PDP_CAP + 1, "posture")}).encode()
            _w, _l, pgot, errs = request_many(pdp_port, [
                ("OPTIONS", "*", None, {"x-forwarded-user": mesh.mesh_users[0]}),
                ("POST", batch_path, b"{nope", JSON_HEADERS),
                ("POST", batch_path, over_cap, JSON_HEADERS),
                ("POST", batch_path, json.dumps({"requests": posture_tuples}).encode(),
                 JSON_HEADERS),
            ], 1)
            if errs:
                fail(f"pdp fail postures: client errors {errs[:3]}")
            posture = [(st, doc.get("decision") or doc.get("error")) for st, doc in pgot[:3]]
            if posture != [(403, "deny"), (400, pgot[1][1].get("error")),
                           (400, f"{PDP_CAP + 1} tuples exceeds the cap of {PDP_CAP}")] or \
                    not pgot[0][1]["reason"].startswith("unmappable request:") or \
                    not pgot[1][1]["error"].startswith("body is not valid JSON"):
                problems.append(f"fail postures: {json.dumps(pgot[:3])[:400]}")
            hold_batches("posture", [posture_tuples], pgot[3:])

            # ---- 2. c=1: fresh checks (the joiners' POSTs gated), then
            # fresh SARs (none gated)
            la = launches_now()
            _w, lat_c1_ext, got, errs = request_many(
                pdp_port, [(m, p, None, h) for m, p, h in c1_checks], 1)
            lb = launches_now()
            if errs:
                fail(f"pdp c=1 checks: client errors {errs[:3]}")
            hold_checks("c1 check", c1_checks, got)
            _w, lat_c1_sar, got, errs = request_many(
                srv.port, [("POST", "/v1/authorize", b, JSON_HEADERS) for b in c1_sars], 1)
            lc = launches_now()
            if errs:
                fail(f"pdp c=1 SARs: client errors {errs[:3]}")
            hold_sars("c1 SAR", c1_sars, got)
            ext_c1_launches, sar_c1_launches = delta(la, lb), delta(lb, lc)
            if not ext_c1_launches["match_groups_kernel"] or sar_c1_launches["match_groups_kernel"]:
                problems.append(f"groups launches: c=1 checks {ext_c1_launches}, c=1 SARs "
                                f"{sar_c1_launches} (want the gated checks' only)")

            # ---- 3. the mixed window: the three protocols at once
            b0 = tenancy_batches(srv)
            groups = {
                "sar": (srv.port, [("POST", "/v1/authorize", b, JSON_HEADERS) for b in mix_sars],
                        PDP_MIX_CLIENTS),
                "extauthz": (pdp_port, [(m, p, None, h) for m, p, h in mix_checks],
                             PDP_MIX_CLIENTS),
                "batch": (pdp_port, [("POST", batch_path, json.dumps({"requests": t}).encode(),
                                      JSON_HEADERS) for t in mix_batches], PDP_BATCH_CLIENTS),
            }
            mixed = {}
            threads = [threading.Thread(target=lambda k=k, g=g: mixed.update(
                {k: request_many(*g)})) for k, g in groups.items()]
            t_mix = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall_mix = time.perf_counter() - t_mix
            b1 = tenancy_batches(srv)
            for k, (_w, _l, _g, errs) in mixed.items():
                if errs:
                    fail(f"pdp mixed window {k}: client errors {errs[:3]}")
            hold_sars("mixed SAR", mix_sars, mixed["sar"][2])
            hold_checks("mixed check", mix_checks, mixed["extauthz"][2])
            hold_batches("mixed batch", mix_batches, mixed["batch"][2])
            mean_batch = (b1[1] - b0[1]) / max(b1[0] - b0[0], 1)

            # ---- 4. one body, two protocols: the check and its
            # byte-identical SAR take independent cache entries
            def cache_counts():
                c = json.loads(http_get(srv.mport, "/debug/cache")[1])["authorization"]
                return c["hits"], c["misses"]

            k0 = cache_counts()
            twin_items = [(pdp_port, twin[0], twin[1], None, twin[2]),
                          (srv.port, "POST", "/v1/authorize", twin_sar, JSON_HEADERS)]
            twin_got = []
            for port, *item in twin_items:
                twin_got += request_many(port, [tuple(item)], 1)[2]
            k1 = cache_counts()
            for port, *item in twin_items:
                twin_got += request_many(port, [tuple(item)], 1)[2]
            k2 = cache_counts()
            hold_checks("twin check", [twin, twin], [twin_got[0], twin_got[2]])
            hold_sars("twin SAR", [twin_sar, twin_sar], [twin_got[1], twin_got[3]])
            if (k1[0] - k0[0], k1[1] - k0[1], k2[0] - k1[0], k2[1] - k1[1]) != (0, 2, 2, 0):
                problems.append(f"twin cache: hits/misses {k0} -> {k1} -> {k2} (want 2 misses, "
                                "then 2 hits on their own entries)")

            # ---- the checks of the whole phase
            e1 = srv.debug_engine()
            l1 = launches_now()
            launches = delta(l0, l1)
            text = http_get(srv.mport, "/metrics")[1].decode()
            print(f"pdp answers ({card}): {n_checked} held against the PdpOracle over the "
                  f"served directory ({sum(len(v[1]) for v in tasks.values())} distinct bodies, "
                  f"{oracle_out['seconds']:.1f} s in the oracle pool), flips {flips}", flush=True)
            if flips:
                problems.append(f"{flips} answers differ from the PdpOracle's")
            mix = e1["authorization"]["pipeline"]["protocol_mix"]
            if not any(set(sig.split(",")) == {"sar", "extauthz", "batch"} for sig in mix):
                problems.append(f"no batch carried all three protocols: {json.dumps(mix)}")
            n_ext = len(c1_checks) + PDP_MIX + 2
            n_tup = 7 + PDP_BATCHES * PDP_TUPLES
            by_proto = {}
            for line in text.splitlines():
                if line.startswith("cedar_authorizer_request_total{") and "protocol=" in line:
                    proto = line.split('protocol="')[1].split('"')[0]
                    by_proto[proto] = by_proto.get(proto, 0) + float(line.rsplit(" ", 1)[1])
            if by_proto != {"extauthz": n_ext, "batch": n_tup}:
                problems.append(f"cedar_authorizer_request_total by protocol {by_proto}, sent "
                                f"{n_ext} checks and {n_tup} tuples")
            audit_by = {}
            with open(audit) as f:
                for line in f:
                    p = json.loads(line).get("protocol", "sar")
                    audit_by[p] = audit_by.get(p, 0) + 1
            n_sar = len(c1_sars) + PDP_MIX + 2
            if audit_by != {"extauthz": n_ext, "batch": n_tup, "sar": n_sar}:
                problems.append(f"audit lines by protocol {audit_by}")
            high = sum(classify("authorization", PdpBody(b, "extauthz")) == PRIORITY_HIGH
                       for b in ext_bodies) + sum(
                classify("authorization", PdpBody(b, "batch")) == PRIORITY_HIGH
                for b in tup_bodies)
            kubelet_named = sum(classify("authorization", b) == PRIORITY_HIGH for b in ext_bodies)
            if high or not kubelet_named:
                problems.append(f"classify: {high} PDP bodies high ({kubelet_named} kubelet-named "
                                "checks would be high as SARs)")
            gated = metric_values(text, "cedar_authorizer_row_routing_total", "row_class",
                                  "authorization").get("gated", 0)
            if not all(launches.values()) or not gated:
                problems.append(f"launches {launches}, gated rows {gated}")
            problems += resilience_quiet("pdp", text)

            # ---- prints
            lat = {k: v[1] for k, v in mixed.items()}
            rps = {k: len(groups[k][1]) / v[0] for k, v in mixed.items()}
            st0, st1 = stage_totals(text0, "authorization"), stage_totals(text, "authorization")
            stage_ms = {k: round((st1[k][0] - st0.get(k, [0, 0])[0]) * 1e3
                                 / max(st1[k][1] - st0.get(k, [0, 0])[1], 1), 3) for k in st1}
            dm = e1["authorization"]["engine"].get("device_memory", {})
            eng = e1["authorization"]["engine"]
            print(f"pdp server ({card}): ready in {ready_s:.1f} s; {mesh.n} policies, L "
                  f"{eng.get('L')} x R {eng.get('R')}, {eng.get('fallback_policies')} fallback "
                  f"policy; c=1 p50 / p99 ms: checks "
                  f"{pct(lat_c1_ext, 50) * 1e3:.3f} / {pct(lat_c1_ext, 99) * 1e3:.3f}, SARs "
                  f"{pct(lat_c1_sar, 50) * 1e3:.3f} / {pct(lat_c1_sar, 99) * 1e3:.3f}; launches "
                  f"c=1 checks {json.dumps(ext_c1_launches)}, c=1 SARs "
                  f"{json.dumps(sar_c1_launches)}", flush=True)
            print(f"pdp mixed window ({card}): {wall_mix:.3f} s; requests/s SAR "
                  f"{rps['sar']:.1f}, ext_authz {rps['extauthz']:.1f}, batch POSTs "
                  f"{rps['batch']:.1f} ({rps['batch'] * PDP_TUPLES:.1f} tuples/s); p50 / p99 ms "
                  + ", ".join(f"{k} {pct(v, 50) * 1e3:.3f} / {pct(v, 99) * 1e3:.3f}"
                              for k, v in lat.items())
                  + f"; mean batch {mean_batch:.2f}; stage means per batch, ms "
                  f"{json.dumps(stage_ms)}; protocol_mix {json.dumps(mix)}", flush=True)
            print(f"pdp server ({card}): launches {json.dumps(launches)}; gated rows {gated:g}; "
                  f"requests by protocol {json.dumps(by_proto)}, audit lines "
                  f"{json.dumps(audit_by)}; twin cache hits/misses {k0} -> {k1} -> {k2}; "
                  f"allocator peak {dm.get('peak_allocated', 0) / 2**20:.1f} MiB, allocated "
                  f"{dm.get('allocated', 0) / 2**20:.1f} MiB", flush=True)
            took, rss = srv.terminate()
            print(f"pdp webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()
    if problems:
        fail("pdp: " + "; ".join(problems))
    print(f"pdp phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


def chaos_builtin(name: str) -> dict:
    """A builtin scenario of the port's chaos package."""
    from cedar_tpu_torch.chaos.scenario import BUILTIN_SCENARIOS

    return BUILTIN_SCENARIOS[name]


if __name__ == "__main__":
    main()
