"""LLMServing — the generative-serving daemon.

Port of ``analytics_zoo_tpu/llm/engine.py``.  Requests arrive as stream
entries on the broker (``uri`` / ``data`` wire frame / ``deadline_ts`` /
``trace_ctx``), results publish to the broker result plane, and the
resilience and observability primitives are wired per *token* instead of
per request:

- admission: one ``AdmissionController`` credit per sequence, acquired
  non-blocking at the reader gate (the decode loop must never park on
  credits) — overload sheds with the machine-readable ``shed`` code.
- deadlines: the wire-carried budget is checked EVERY decode step, so
  an expired sequence retires mid-generation (code ``expired``), partial
  tokens already streamed.
- a failed step error-finishes every slotted sequence — blocks freed,
  credits released, terminal frames published — and the loop keeps
  serving.
- tracing: each prefill chunk runs under an ``llm.prefill`` span parented
  to the wire context; every emitted token journals an ``llm.token``
  event and every retirement an ``llm.finish`` event, tagged with the
  request's trace id.
- chaos: the injection points ``broker_read``, ``decode_step``,
  ``prefix_match`` and ``prefill_chunk``, all on the host between
  launches.
- flight recorder: block-pool exhaustion (``kv_exhausted``) and a dying
  engine thread dump the black box.
- metrics: the ``zoo_llm_*`` series, recorded from host-side books only
  (no record reads a CUDA tensor).

Each engine step runs a fixed TOKEN budget of chunked prefill
(``DecoderLM.prefill_chunk`` → the ``paged_chunk`` kernel), then one decode
step over every decoding sequence (``DecoderLM.decode`` → the
``paged_decode`` kernel).  The greedy argmax runs on the device and only
the chosen ids come to the host, one copy per step.

Token streaming: every generated token is published IMMEDIATELY as one
binary wire frame (``{"index", "token"}`` int32 scalars) on the broker
stream ``llmtok:<uri>``, the terminal entry carrying ``done``/``code``;
the aggregate result lands on ``result:<uri>`` like every other workload
so ``OutputQueue`` clients keep working.

The HTTP face is ``serving.http_frontend.ServingFrontend(llm=...)``.
Any broker of ``serving.broker.get_broker`` carries it: ``memory://``,
``native://``, ``redis://`` and ``fleet://``.
``model_parallel > 1`` is refused by ``LLMServingConfig`` (ROADMAP Queue 1
item 5).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import CancelledError
from typing import Dict, List, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import LLMServingConfig
from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.resilience import (
    AdmissionController, Deadline, record_expired)
from analytics_zoo_tpu_torch.llm.kv_cache import (
    BlockPoolExhausted, PagedKVCache)
from analytics_zoo_tpu_torch.llm.scheduler import (
    DECODING, PREFILL, ContinuousBatchingScheduler, GenSequence)
from analytics_zoo_tpu_torch.observability import flight_recorder
from analytics_zoo_tpu_torch.serving.broker import get_broker
from analytics_zoo_tpu_torch.serving.codec import (
    decode_items, encode_items_bytes)
from analytics_zoo_tpu_torch.testing import chaos

logger = logging.getLogger("analytics_zoo_tpu_torch.llm")


def token_stream_name(uri: str) -> str:
    """The broker stream carrying one request's token frames."""
    return f"llmtok:{uri}"


#: terminal-frame outcome codes (the frame is all-int fast wire, so the
#: code rides numerically; string names stay on the broker fields)
TERMINAL_CODES = {"ok": 0, "error": 1, "shed": 2, "expired": 3,
                  "cancelled": 4}
CODE_NAMES = {v: k for k, v in TERMINAL_CODES.items()}

#: blocks reclaimed from the radix cache per eviction pass: with the
#: cache on, the steady state is a (nearly) full pool, so single-block
#: reclaims would pay the evictor's tree walk at every block boundary —
#: batching keeps a small free headroom and amortizes the walk
_RECLAIM_BATCH = 8


def _same_device(a: torch.device, b: torch.device) -> bool:
    index = lambda d: (torch.cuda.current_device()
                       if d.type == "cuda" and d.index is None else d.index)
    return a.type == b.type and index(a) == index(b)


class LLMServing:
    """Continuous-batching generative serving over a paged KV cache.

    ``device=None`` means the card (``resolve_device``); the model must
    lie on the serving device.
    """

    def __init__(self, model, config: Optional[LLMServingConfig] = None,
                 broker=None, device=None):
        self.config = config or LLMServingConfig()
        cfg = self.config
        self.device = resolve_device(device)
        if not _same_device(model.device, self.device):
            raise ValueError(f"the model lies on {model.device}, the "
                             f"serving device is {self.device}")
        self.model = model
        self.broker = broker or get_broker(
            None if cfg.redis_url.startswith("memory")
            else cfg.redis_url)
        self.stream = cfg.input_stream
        self.group = cfg.consumer_group
        self.broker.xgroup_create(self.stream, self.group)
        if cfg.max_model_len > model.max_pos:
            raise ValueError(
                f"max_model_len {cfg.max_model_len} exceeds the model's "
                f"position table ({model.max_pos})")
        self.cache = PagedKVCache(
            model.n_layers, cfg.num_blocks, cfg.block_size,
            model.n_kv_heads, model.head_dim, dtype=model.dtype,
            prefix_cache=cfg.prefix_cache, device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            self.cache, cfg.max_active, mode=cfg.scheduling)
        self.table_width = -(cfg.max_model_len // -cfg.block_size)
        if cfg.admission_control:
            credits = cfg.admission_max_inflight or 4 * cfg.max_active
            self.admission: Optional[AdmissionController] = \
                AdmissionController(credits, name="llm")
        else:
            self.admission = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # cancels arrive from other threads; processed at the top of each
        # engine step.  Pre-arrival cancels are kept (bounded) so a
        # disconnect can outrun its own request.
        self._cancel_lock = threading.Lock()
        self._cancelled: Dict[str, None] = {}
        self._finished_streams: List[str] = []
        # the plain counters of metrics() + the registry series
        self._m_tokens = obs.lazy_counter(
            "zoo_llm_tokens_total", "generated tokens published")
        self._m_tps = obs.lazy_gauge(
            "zoo_llm_tokens_per_s",
            "generated tokens/sec over the last ~1s window")
        self._m_ttft = obs.lazy_histogram(
            "zoo_llm_ttft_seconds",
            "enqueue -> first streamed token")
        self._m_itl = obs.lazy_histogram(
            "zoo_llm_intertoken_seconds",
            "gap between consecutive streamed tokens of one sequence")
        self._m_occ = obs.lazy_histogram(
            "zoo_llm_batch_occupancy",
            "live sequences / decode slots per step",
            buckets=(0.125, 0.25, 0.5, 0.75, 0.875, 1.0))
        self._m_blocks = obs.lazy_gauge(
            "zoo_llm_kv_blocks_in_use", "allocated KV blocks")
        self._m_util = obs.lazy_gauge(
            "zoo_llm_kv_block_utilization",
            "allocated / total KV blocks")
        self._m_preempt = obs.lazy_counter(
            "zoo_llm_preemptions_total",
            "sequences evicted on KV block exhaustion")
        self._m_seqs = obs.lazy_counter(
            "zoo_llm_sequences_total",
            "sequences finished by outcome", ["outcome"])
        self._m_prefix_hits = obs.lazy_counter(
            "zoo_llm_prefix_hits_total",
            "prefills that adopted a cached prefix (radix cache)")
        self._m_prefix_misses = obs.lazy_counter(
            "zoo_llm_prefix_misses_total",
            "prefills that matched no cached prefix")
        self._m_prefix_tokens = obs.lazy_counter(
            "zoo_llm_prefix_tokens_saved_total",
            "prompt tokens adopted from the radix cache (not recomputed)")
        self._m_prefix_bytes = obs.lazy_counter(
            "zoo_llm_prefix_bytes_saved_total",
            "KV bytes adopted from the radix cache instead of prefilled")
        self._m_prefix_blocks = obs.lazy_gauge(
            "zoo_llm_prefix_cached_blocks",
            "KV blocks currently held by the radix prefix cache")
        self._m_prefix_evict = obs.lazy_counter(
            "zoo_llm_prefix_evictions_total",
            "radix cache blocks evicted (LRU-by-leaf) under pool pressure")
        self._m_chunks = obs.lazy_counter(
            "zoo_llm_prefill_chunks_total",
            "prefill chunks executed (chunked prefill)")
        self._preempt_reported = 0
        self._evict_reported = 0
        self._metrics_lock = threading.Lock()
        self.tokens_generated = 0
        self.sequences_finished = 0
        self.sequences_shed = 0
        self.sequences_expired = 0
        self._window_start = time.monotonic()
        self._window_tokens = 0
        self.tokens_per_s = 0.0
        self._occ_sum = 0.0
        self._occ_n = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._itl_sum = 0.0
        self._itl_n = 0
        self._ttft_samples: List[tuple] = []   # (uri, ttft_seconds)
        self._prefill_tick = 0

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "LLMServing":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("LLMServing already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run_stage, name="llm-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)

    def cancel(self, uri: str) -> None:
        """Mark one request cancelled (client abort): its KV blocks free
        and a terminal ``cancelled`` frame publishes at the next engine
        step."""
        with self._cancel_lock:
            self._cancelled[uri] = None
            while len(self._cancelled) > 1024:
                self._cancelled.pop(next(iter(self._cancelled)))

    def _run_stage(self) -> None:
        """Engine-thread entry: the loop guards its own body, so anything
        escaping here IS a dying worker — snapshot, then die loudly."""
        try:
            self._loop()
        except BaseException as exc:
            logger.exception("llm engine thread died")
            obs.add_event("thread_death", span=None, thread="llm-engine",
                          error=f"{type(exc).__name__}: {exc}")
            flight_recorder.get().trigger("thread_death",
                                          detail="llm-engine")
            raise

    # ---- the continuous-batching loop -------------------------------------
    def _loop(self) -> None:
        while True:
            if self._stop.is_set():
                self._drain_on_stop()
                return
            busy = self.scheduler.has_work()
            try:
                self._poll_requests(block_ms=0 if busy else 20)
                chaos.fire("decode_step")
                self._step()
            except (Exception, CancelledError) as exc:
                # one faulted step must not strand its sequences: every
                # slotted/waiting sequence error-finishes — blocks
                # freed, credits released, terminal frames out — and
                # the loop keeps serving
                logger.exception("llm engine step failed; erroring "
                                 "its sequences")
                self._fail_all(exc)

    def _drain_on_stop(self) -> None:
        for seq in list(self.scheduler.waiting) + self.scheduler.active():
            self._finish(seq, code="cancelled",
                         error="engine stopped mid-generation")

    def _fail_all(self, exc: BaseException) -> None:
        for seq in list(self.scheduler.waiting) + self.scheduler.active():
            self._finish(seq, code="error",
                         error=str(exc) or type(exc).__name__)

    def _step(self) -> None:
        self._process_cancels()
        self._expire_deadlines()
        self.scheduler.schedule_admissions()
        # chunked prefill/decode interleaving: a fixed TOKEN budget of
        # prefill work runs between decode steps — one long prompt
        # costs the decode lanes at most one budget's compute per step
        # (bounded ITL).  Ordering inside the budget ALTERNATES:
        # shortest-remaining-first steps (a short prompt behind a long
        # one completes inside its arrival step — bounded TTFT)
        # interleaved with oldest-admission-first steps (pure SRPT
        # would starve a long prompt indefinitely under a sustained
        # stream of short arrivals; giving the oldest first claim on
        # every second budget bounds its prefill at ~2·len/budget
        # steps regardless of load).
        pending = [s for s in self.scheduler.active()
                   if s.state == PREFILL]
        spent = 0
        if pending:
            budget = max(self.config.prefill_chunk_tokens, 1)
            self._prefill_tick += 1
            order = sorted(
                pending, key=lambda s: s.context_len - s.prefill_pos)
            if self._prefill_tick % 2 == 0:
                oldest = min(pending, key=lambda s: s.arrival)
                order.remove(oldest)
                order.insert(0, oldest)
            for seq in order:
                if spent >= budget:
                    break
                spent += self._prefill_chunk(seq, budget - spent)
        decoded = self._decode_once()
        if spent and not decoded and self.cache.device.type == "cuda":
            # prefill-only step: the decode step's host read, which
            # normally bounds the queue of launched work, didn't run —
            # without this the loop keeps launching chunks and the NEXT
            # sequence's first read stalls behind the whole backlog
            torch.cuda.current_stream(self.cache.device).synchronize()
        # host-side books only: no record reads a CUDA tensor
        pool = self.cache.pool
        self._m_blocks.set(float(pool.blocks_in_use))
        self._m_util.set(pool.blocks_in_use / max(pool.num_blocks, 1))
        pc = self.cache.prefix_cache
        if pc is not None:
            self._m_prefix_blocks.set(float(pc.cached_blocks))
            if pc.evictions > self._evict_reported:
                self._m_prefix_evict.inc(pc.evictions
                                         - self._evict_reported)
                self._evict_reported = pc.evictions
        sched = self.scheduler
        if sched.preemptions > self._preempt_reported:
            self._m_preempt.inc(sched.preemptions
                                - self._preempt_reported)
            self._preempt_reported = sched.preemptions

    # ---- request intake ---------------------------------------------------
    def _poll_requests(self, block_ms: int) -> None:
        try:
            chaos.fire("broker_read")
            entries = self.broker.xreadgroup(
                self.stream, self.group, "llm-engine",
                count=2 * self.config.max_active, block_ms=block_ms)
        except (Exception, CancelledError):
            logger.exception("llm request read failed; retrying")
            time.sleep(0.05)
            return
        for sid, fields in entries or []:
            self._admit(sid, fields)

    def _admit(self, sid: str, fields: dict) -> None:
        uri = fields.get("uri", "?")
        tref = None
        if obs.get_tracer().enabled:
            tref = obs.decode_trace_context(fields.get("trace_ctx"))
        try:
            self.broker.xack(self.stream, self.group, sid)
        except (Exception, CancelledError):
            logger.exception("could not ack llm entry %s", sid)
        dl = self._entry_deadline(fields)
        if dl is not None and dl.expired:
            record_expired(1, scope="llm",
                           trace_id=tref[0] if tref else None)
            with self._metrics_lock:
                self.sequences_expired += 1
            self._publish_terminal(uri, code="expired",
                                   error="deadline expired before "
                                         "admission")
            self._count_seq("expired")
            return
        try:
            items = decode_items(fields["data"])
            prompt = np.asarray(items["tokens"]).reshape(-1)
            if prompt.size < 1:
                raise ValueError("empty prompt")
            max_new = int(np.asarray(items.get(
                "max_new_tokens",
                self.config.max_new_tokens_default)).reshape(()))
            priority = int(np.asarray(items.get("priority", 0))
                           .reshape(()))
            if max_new < 1:
                raise ValueError(f"max_new_tokens must be >= 1, "
                                 f"got {max_new}")
            if prompt.size + max_new > self.config.max_model_len:
                raise ValueError(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({max_new}) exceeds max_model_len "
                    f"{self.config.max_model_len}")
        except (Exception, CancelledError) as exc:
            logger.exception("undecodable llm entry %s", uri)
            self._publish_terminal(uri, code="error",
                                   error=str(exc) or type(exc).__name__)
            self._count_seq("error")
            return
        adm = self.admission
        if adm is not None and not adm.try_acquire(1):
            # non-blocking by design: the decode loop cannot park on
            # credits without stalling every running sequence's ITL
            adm.shed(1, scope="llm", trace_id=tref[0] if tref else None)
            with self._metrics_lock:
                self.sequences_shed += 1
            self._publish_terminal(
                uri, code="shed",
                error="llm engine overloaded; admission control shed "
                      "this request — retry with backoff")
            self._count_seq("shed")
            return
        seq = GenSequence(uri, prompt.tolist(), max_new,
                          priority=priority, deadline=dl, tref=tref)
        seq.credits = 1 if adm is not None else 0
        with self._cancel_lock:
            pre_cancelled = self._cancelled.pop(uri, "?") is None
        if pre_cancelled:
            self._finish(seq, code="cancelled",
                         error="cancelled before admission")
            return
        self.scheduler.add(seq)

    def _entry_deadline(self, fields) -> Optional[Deadline]:
        ts = fields.get("deadline_ts")
        if ts is not None:
            try:
                return Deadline.from_wall(float(ts))
            except (TypeError, ValueError):
                logger.warning("unparsable deadline_ts %r ignored", ts)
        if self.config.default_deadline_ms:
            return Deadline(self.config.default_deadline_ms / 1e3)
        return None

    # ---- per-step bookkeeping ---------------------------------------------
    def _process_cancels(self) -> None:
        with self._cancel_lock:
            if not self._cancelled:
                return
            uris = [u for u in self._cancelled
                    if self.scheduler.find(u) is not None]
            for u in uris:
                del self._cancelled[u]
        for u in uris:
            seq = self.scheduler.find(u)
            if seq is not None:
                self._finish(seq, code="cancelled",
                             error="cancelled by client")

    def _expire_deadlines(self) -> None:
        """The per-TOKEN deadline gate: runs every step, so a sequence
        whose budget ran out mid-generation stops costing device time
        at the very next token boundary."""
        for seq in (list(self.scheduler.waiting)
                    + self.scheduler.active()):
            if seq.deadline is not None and seq.deadline.expired:
                record_expired(
                    1, scope="llm",
                    trace_id=seq.tref[0] if seq.tref else None)
                with self._metrics_lock:
                    self.sequences_expired += 1
                self._finish(seq, code="expired",
                             error=f"deadline expired after "
                                   f"{len(seq.generated)} tokens")

    # ---- prefill ----------------------------------------------------------
    def _prefill_chunk(self, seq: GenSequence, budget: int) -> int:
        """Run ONE chunk (≤ ``budget`` tokens) of ``seq``'s prefill;
        returns the tokens consumed from the step's budget.

        The first chunk consults the radix prefix cache: a matched
        prefix's blocks are adopted by refcount bump (zero recompute)
        and prefill starts at the match point.  The final chunk's
        logits are the first generated token; the completed context's
        full blocks then insert into the cache for the next sharer.
        """
        cache = self.cache
        ctx = seq.prompt + seq.generated
        if (seq.prefill_pos == 0 and not seq.prefix_checked
                and cache.prefix_cache is not None):
            # once per slotting: a block-exhaustion retry next step
            # must not re-fire the chaos point or recount the miss
            seq.prefix_checked = True
            chaos.fire("prefix_match")
            matched = cache.adopt_prefix(seq.uri, ctx)
            if matched:
                seq.prefill_pos = matched
                self._m_prefix_hits.inc()
                self._m_prefix_tokens.inc(matched)
                self._m_prefix_bytes.inc(
                    matched * cache.kv_bytes_per_token)
                obs.add_event(
                    "llm.prefix_hit", span=None,
                    trace_id=seq.tref[0] if seq.tref else None,
                    uri=seq.uri, tokens=matched)
            elif len(ctx) > cache.block_size:
                # prompts shorter than one block can never match or
                # insert; counting them as misses would drown the rate
                self._m_prefix_misses.inc()
        chunk = max(self.config.prefill_chunk_tokens, 1)
        n = min(budget, chunk, len(ctx) - seq.prefill_pos)
        if n <= 0:
            return 0
        chaos.fire("prefill_chunk")
        try:
            slots = cache.append_tokens(seq.uri, n)
        except BlockPoolExhausted:
            if cache.reclaim(_RECLAIM_BATCH):
                return 0       # cold cache blocks freed; retry next step
            # schedule_admissions sized this; losing the race to a
            # cancel-refill means waiting one more step, not failing
            self.scheduler.preempt(seq)
            return 0           # nothing prefilled: don't debit budget
        toks = np.zeros((chunk,), np.int32)
        toks[:n] = ctx[seq.prefill_pos:seq.prefill_pos + n]
        pslots = np.arange(chunk, dtype=np.int32) % cache.block_size
        pslots[:n] = slots             # padding writes land on scratch
        table = cache.page_table(seq.uri, self.table_width)
        self._m_chunks.inc()
        with obs.span("llm.prefill", parent=seq.tref, uri=seq.uri,
                      start=seq.prefill_pos, tokens=n,
                      resumed=bool(seq.preemptions)):
            logits, cache.k_pages, cache.v_pages = \
                self.model.prefill_chunk(toks, seq.prefill_pos, n, table,
                                         cache.k_pages, cache.v_pages,
                                         pslots)
            seq.prefill_pos += n
            if seq.prefill_pos < len(ctx):
                return n               # more chunks to go
            tok = int(logits.argmax())
        cache.insert_prefix(seq.uri, ctx)
        seq.state = DECODING
        self._emit_token(seq, tok)
        if seq.done or tok == self.config.eos_id:
            self._finish(seq, code="ok")
        return n

    # ---- decode -----------------------------------------------------------
    def _decode_once(self) -> int:
        """One decode step over every DECODING sequence; returns the
        live-lane count (0 == no device sync happened here)."""
        seqs = self.scheduler.decoding()
        if not seqs:
            return 0
        # pass 1 — reserve one block-table slot per sequence for the
        # token being fed this step.  Exhaustion preempts a victim
        # (recompute-on-resume) — a preempted victim may itself be a
        # sequence from this list, so lane building happens ONLY in
        # pass 2, over the survivors: a lane must never point at blocks
        # a preemption just returned to the pool (another survivor may
        # already own them again).
        reserved: Dict[str, int] = {}
        for seq in seqs:
            if seq.state != DECODING:
                # already preempted as a victim for an EARLIER
                # sequence's reservation: its table is freed — an
                # append here would auto-create a stale one-token
                # table that poisons the resume prefill
                continue
            while True:
                try:
                    reserved[seq.uri] = \
                        int(self.cache.append_tokens(seq.uri, 1)[0])
                    break
                except BlockPoolExhausted:
                    if self.cache.reclaim(_RECLAIM_BATCH):
                        # cold radix-cache blocks covered it: with the
                        # cache on, a full pool is the NORMAL steady
                        # state
                        continue
                    flight_recorder.get().trigger(
                        "kv_exhausted",
                        detail=f"blocks={self.cache.pool.num_blocks}",
                        min_interval_s=5.0)
                    obs.add_event(
                        "llm.kv_exhausted", span=None,
                        trace_id=seq.tref[0] if seq.tref else None,
                        uri=seq.uri)
                    if not self.scheduler.free_blocks_for_decode(seq):
                        # nothing left to evict: the pool cannot hold
                        # even this one sequence's next token — a
                        # sizing error, not load
                        self._finish(seq, code="error",
                                     error="KV block pool exhausted "
                                           "with no evictable sequence")
                        break
        # pass 2 — build decode lanes for sequences still resident
        live = [s for s in seqs if s.state == DECODING
                and s.uri in reserved]
        if not live:
            return 0
        self._m_occ.observe(len(live) / self.scheduler.max_slots)
        with self._metrics_lock:
            self._occ_sum += len(live) / self.scheduler.max_slots
            self._occ_n += 1
        B = self.scheduler.max_slots
        bs = self.cache.block_size
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        slots = np.arange(B, dtype=np.int32) % bs   # dead -> scratch
        tables = np.zeros((B, self.table_width), np.int32)
        for seq in live:
            i = seq.slot
            tokens[i] = seq.generated[-1]
            kv_tokens = self.cache.table(seq.uri).num_tokens
            positions[i] = kv_tokens - 1
            lengths[i] = kv_tokens
            slots[i] = reserved[seq.uri]
            tables[i] = self.cache.page_table(seq.uri, self.table_width)
        # the decode step runs ON the engine thread: step N+1 consumes
        # step N's pages, so a dispatch pool could never overlap steps
        logits, self.cache.k_pages, self.cache.v_pages = \
            self.model.decode(tokens, positions, lengths, tables,
                              self.cache.k_pages, self.cache.v_pages,
                              slots)
        chosen = logits.argmax(dim=-1).cpu().numpy()   # one host read
        for seq in live:
            if seq.state != DECODING:
                continue
            tok = int(chosen[seq.slot])
            self._emit_token(seq, tok)
            if seq.done or tok == self.config.eos_id:
                self._finish(seq, code="ok")
        return len(live)

    # ---- publication ------------------------------------------------------
    def _emit_token(self, seq: GenSequence, token: int) -> None:
        idx = len(seq.generated)
        seq.generated.append(token)
        now = time.monotonic()
        if seq.t_first_token is None:
            self._m_ttft.observe(now - seq.t_enqueue)
        else:
            self._m_itl.observe(now - seq.t_last_token)
        with self._metrics_lock:
            if seq.t_first_token is None:
                seq.t_first_token = now
                self._ttft_sum += now - seq.t_enqueue
                self._ttft_n += 1
                self._ttft_samples.append((seq.uri,
                                           now - seq.t_enqueue))
                if len(self._ttft_samples) > 4096:
                    del self._ttft_samples[:2048]
            else:
                self._itl_sum += now - seq.t_last_token
                self._itl_n += 1
        seq.t_last_token = now
        obs.add_event("llm.token", span=None,
                      trace_id=seq.tref[0] if seq.tref else None,
                      uri=seq.uri, idx=idx)
        # ndim-0 ARRAYS, not numpy scalars: a np.int32 scalar fails the
        # codec's ndarray fast-wire check and falls back to the much
        # slower Arrow frame
        frame = encode_items_bytes(
            {"index": np.asarray(idx, np.int32),
             "token": np.asarray(token, np.int32)})
        try:
            self.broker.xadd(token_stream_name(seq.uri),
                             {"idx": str(idx), "frame": frame})
        except (Exception, CancelledError):
            logger.exception("token publish failed for %s", seq.uri)
        self._m_tokens.inc()
        with self._metrics_lock:
            self.tokens_generated += 1
            self._window_tokens += 1
            if now - self._window_start >= 1.0:
                self.tokens_per_s = (self._window_tokens
                                     / (now - self._window_start))
                self._m_tps.set(self.tokens_per_s)
                self._window_start, self._window_tokens = now, 0

    def _publish_terminal(self, uri: str, code: str = "ok",
                          error: Optional[str] = None,
                          n_tokens: int = 0) -> None:
        frame = encode_items_bytes(
            {"done": np.asarray(1, np.int32),
             "n": np.asarray(n_tokens, np.int32),
             "code": np.asarray(TERMINAL_CODES.get(code, 1), np.int32)})
        fields = {"idx": str(n_tokens), "done": "1", "code": code,
                  "frame": frame}
        if error:
            fields["error"] = error
        try:
            self.broker.xadd(token_stream_name(uri), fields)
        except (Exception, CancelledError):
            logger.exception("terminal publish failed for %s", uri)

    def _finish(self, seq: GenSequence, code: str = "ok",
                error: Optional[str] = None) -> None:
        """The ONE retirement path (ok/expired/cancelled/error): free
        blocks + slot, release the credit exactly once, publish the
        terminal stream entry and the aggregate result."""
        self.scheduler.remove(seq)
        if seq.credits:
            seq.credits = 0
            if self.admission is not None:
                self.admission.release(1)
        obs.add_event("llm.finish", span=None,
                      trace_id=seq.tref[0] if seq.tref else None,
                      uri=seq.uri, code=code,
                      tokens=len(seq.generated))
        self._publish_terminal(seq.uri, code=code, error=error,
                               n_tokens=len(seq.generated))
        try:
            if code == "ok":
                # the frame's tensor is named "value" so the ordinary
                # OutputQueue/decode_output result path reads it
                value = encode_items_bytes(
                    {"value": np.asarray(seq.generated, np.int32)})
                self.broker.set_results(
                    {f"result:{seq.uri}": {"value": value}})
            else:
                self.broker.set_results(
                    {f"result:{seq.uri}":
                     {"error": error or code, "code": code}})
        except (Exception, CancelledError):
            logger.exception("result publish failed for %s", seq.uri)
        with self._metrics_lock:
            self.sequences_finished += 1
        self._count_seq(code)
        self._gc_token_streams(seq.uri)

    def _count_seq(self, outcome: str) -> None:
        self._m_seqs.labels(outcome=outcome).inc()

    def _gc_token_streams(self, uri: str) -> None:
        """Bound broker memory: completed token streams older than the
        retention window are dropped (a reader lagging that far behind
        sees a truncated stream)."""
        drop = getattr(self.broker, "delete_stream", None)
        if drop is None:
            return
        self._finished_streams.append(token_stream_name(uri))
        while len(self._finished_streams) > \
                self.config.token_stream_retention:
            old = self._finished_streams.pop(0)
            try:
                drop(old)
            except (Exception, CancelledError):
                logger.exception("token-stream GC failed for %s", old)

    # ---- introspection ----------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the windowed accumulators (mean occupancy / TTFT / ITL)
        so a bench can measure steady state after its warmup."""
        with self._metrics_lock:
            self._occ_sum = 0.0
            self._occ_n = 0
            self._ttft_sum = 0.0
            self._ttft_n = 0
            self._itl_sum = 0.0
            self._itl_n = 0
            self._ttft_samples = []

    def ttft_samples(self) -> List[tuple]:
        """Per-sequence ``(uri, enqueue→first-token seconds)`` since
        the last ``reset_stats`` (bounded)."""
        with self._metrics_lock:
            return list(self._ttft_samples)

    def metrics(self) -> Dict[str, object]:
        with self._metrics_lock:
            occ = (self._occ_sum / self._occ_n) if self._occ_n else 0.0
            ttft = ((self._ttft_sum / self._ttft_n)
                    if self._ttft_n else 0.0)
            itl = (self._itl_sum / self._itl_n) if self._itl_n else 0.0
            out = {"tokens_generated": self.tokens_generated,
                   "tokens_per_s": round(self.tokens_per_s, 2),
                   "sequences_finished": self.sequences_finished,
                   "sequences_shed": self.sequences_shed,
                   "sequences_expired": self.sequences_expired,
                   "preemptions": self.scheduler.preemptions,
                   "mean_batch_occupancy": round(occ, 4),
                   "mean_ttft_ms": round(1e3 * ttft, 3),
                   "mean_itl_ms": round(1e3 * itl, 3),
                   "kv_blocks_in_use": self.cache.pool.blocks_in_use,
                   "kv_blocks_total": self.cache.pool.num_blocks}
        pc = self.cache.prefix_cache
        if pc is not None:
            looked = pc.hits + pc.misses
            out["prefix_cache"] = {
                "hits": pc.hits, "misses": pc.misses,
                "hit_rate": round(pc.hits / looked, 4) if looked else 0.0,
                "tokens_saved": pc.tokens_saved,
                "bytes_saved": pc.tokens_saved
                * self.cache.kv_bytes_per_token,
                "cached_blocks": pc.cached_blocks,
                "evictions": pc.evictions}
        adm = self.admission
        if adm is not None:
            out["admission"] = {"capacity": adm.capacity,
                                "in_flight": adm.in_flight}
        return out
