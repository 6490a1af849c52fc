"""Continuous batching for LM decode: a fixed slot pool — port of
``keystone_tpu/serve/decode_loop.py``.

The pool holds ``slots`` sequences in one batched cache. Each decode step
advances every active slot together; finished sequences retire (EOS or
length) and queued prompts prefill into freed slots between steps, so
aggregate tokens/s grows with occupancy. Built on the per-row cache
positions of :func:`keystone_tpu_torch.models.lm.decode.decode_step`
(a (B,) ``pos`` tensor): slots join at different times with different
prompt lengths and are never position-aligned.

Everything device-side is two kinds of program — the pooled decode step
and the per-bucket prefill — plus a slot merge. Where the JAX package
compiles them ahead of time, the port captures them on the card as CUDA
graphs in :meth:`DecodeLoop.warm`: one graph for the pooled step (decode
step and pick over the pool's cache, (slots,) static token input) and
one per prefill bucket width ((1, width) static tokens and a (1,) static
length). After that a step or an admission only copies into the static
inputs, replays, and reads the picked tokens back. A capture that fails
raises; a step on the card before :meth:`warm` captures first. On the
CPU the loop runs eagerly.

A tensor-parallel model (``shard_params``) serves through the same loop.
In one process every position of the model axis runs on the loop's
device, and the graphs hold every position's work. Across processes
every rank runs the same loop on the same prompts, as the JAX package's
one SPMD program would, and its cache holds the rank's KV heads; over
NCCL the graphs are captured with their collectives. A gloo group cannot
be captured (it moves a card's values through the host), so a loop over
a gloo model axis runs eagerly on the card and ``graphed`` stays False.

The pool's cache is written in place: a merge copies a prefilled
sequence into its slot, and each step writes the new position of every
slot back into the pool's one ``pos`` buffer, which the step graph reads
on every replay.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from keystone_tpu_torch.core.kernels import KERNELS
from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.models.lm.decode import (
    KVCache,
    cache_heads,
    decode_step,
    pick,
    prefill,
)
from keystone_tpu_torch.observe import metrics as _metrics
from keystone_tpu_torch.observe import spans as _spans
from keystone_tpu_torch.observe import telemetry as _telemetry
from keystone_tpu_torch.serve.export import side_stream_warmup
from keystone_tpu_torch.serve.queue import ServeFuture

logger = get_logger("keystone_tpu_torch.serve.decode_loop")


class _Sequence:
    __slots__ = (
        "rid", "tokens", "remaining", "future", "submitted", "ctx",
        "gen_ctx",
    )

    def __init__(self, rid, remaining: int, future: ServeFuture, ctx=None):
        self.rid = rid
        self.tokens: list[int] = []
        self.remaining = remaining
        self.future = future
        self.submitted = time.perf_counter()
        # ctx: the submitter's span context (captured at submit — the
        # decode worker thread has no ambient context); gen_ctx: the
        # pre-allocated slot-span ids so the prefill recorded at admit
        # parents on the generation span recorded at retire
        self.ctx = ctx
        self.gen_ctx = None


class _Graph(NamedTuple):
    """A captured program: replay after copying into ``inputs``; read
    ``outputs`` before the next replay of any graph of the loop."""

    graph: Any  # torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    # the hand kernels' launches a replay makes: the wrapper counts that
    # ticked while the graph was captured
    launches: dict


def _over_gloo(model) -> bool:
    """True when the model's axis spans processes over gloo."""
    tp = model.tp
    if tp is None or not tp.local:
        return False
    import torch.distributed as dist

    return dist.get_backend(tp.comm.group.pg) == "gloo"


def _merge_slot(pool: KVCache, one: KVCache, slot: int) -> None:
    """Write a freshly prefilled single-sequence cache into pool slot
    ``slot``, in place. Both hold the same KV heads: every head in one
    process, the rank's own across processes."""
    pool.k[:, slot] = one.k[:, 0]
    pool.v[:, slot] = one.v[:, 0]
    pool.pos[slot] = one.pos[0]
    if pool.k_scale is not None:
        pool.k_scale[:, slot] = one.k_scale[:, 0]
        pool.v_scale[:, slot] = one.v_scale[:, 0]


class DecodeLoop:
    """Continuous-batching generation over a fixed pool of decode slots.

    ``submit`` queues a prompt and returns a future resolving to the
    generated ``(n,) int32`` tokens (EOS included when hit); ``step``
    admits queued prompts into free slots, advances every active slot
    one token, and retires finished sequences. ``run`` drives steps until
    a set of futures resolves; a server runs :meth:`worker` in a thread.

    Sampling config is fixed per loop (it is baked into the captured
    programs); prompts are bucketed to ``prefill_buckets`` widths, one
    prefill graph per width.
    """

    def __init__(
        self,
        model,
        *,
        slots: int = 8,
        s_max: int = 512,
        kv_dtype: str | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: int | None = None,
        max_new: int = 64,
        prefill_buckets: Sequence[int] | None = None,
        seed: int = 0,
    ):
        if slots < 1:
            raise ValueError(f"slots={slots}: need >= 1")
        self.model = model
        self.slots = slots
        self.s_max = s_max
        self.kv_dtype = kv_dtype
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.default_max_new = max_new
        if prefill_buckets is None:
            # the ladder covers every admissible prompt length, so warm()
            # captures every prefill the request path can need
            buckets, b = [], 8
            while b < s_max:
                buckets.append(b)
                b *= 4
            buckets.append(s_max)
            prefill_buckets = buckets
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.device = model.device
        self._capturable = self.device.type == "cuda" and not _over_gloo(model)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._slots: list[_Sequence | None] = [None] * slots
        self._tok = np.zeros(slots, np.int64)
        self.cache = self._empty_cache()
        # CUDA graphs (card only): the pooled step and one prefill per
        # bucket width, sharing one memory pool
        self._step_graph: _Graph | None = None
        self._prefill_graphs: dict[int, _Graph] = {}
        self._pool = None
        self._tok_host: torch.Tensor | None = None  # pinned step input
        self.tokens_out = 0
        self.occupancy_steps = 0  # sum of active slots over steps
        # graph replays by kind, and the hand kernels' launches they made:
        # a replay calls no kernel wrapper, so this is how a server
        # accounts for the kernels it launched from graphs
        self.replays = {"prefill": 0, "step": 0}
        self.graph_launches: dict[str, int] = collections.Counter()

    # ------------------------------------------------------------- state

    @property
    def graphed(self) -> bool:
        """True once the step graph is captured (on the card, after
        :meth:`warm`; never over a gloo model axis, see the module
        docstring)."""
        return self._step_graph is not None

    @torch.inference_mode()
    def _empty_cache(self) -> KVCache:
        m = self.model
        d = m.embed.shape[-1]
        hd = d // m.num_heads
        shape = (len(m.blocks), self.slots, cache_heads(m), self.s_max, hd)
        # a (slots,) pos even at one slot: the pool never takes
        # decode_step's scalar-position branch, which reads pos on the host
        pos = torch.zeros(self.slots, dtype=torch.long, device=self.device)
        if self.kv_dtype == "int8":
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=self.device),
                v=torch.zeros(shape, dtype=torch.int8, device=self.device),
                pos=pos,
                k_scale=torch.zeros((*shape[:-1], 1), device=self.device),
                v_scale=torch.zeros((*shape[:-1], 1), device=self.device),
            )
        return KVCache(
            k=torch.zeros(shape, dtype=m.cdt, device=self.device),
            v=torch.zeros(shape, dtype=m.cdt, device=self.device),
            pos=pos,
        )

    def _pick(self, logits):
        if self.temperature != 0.0:
            # idle slots run past their end and carry NaN logits; they are
            # never read, but the sampler takes no NaN
            logits = torch.nan_to_num(logits, nan=0.0)
        return pick(logits, self.temperature, self.top_k, self.top_p, self._gen)

    # ---------------------------------------------------------- programs

    def _prefill(self, tokens, lengths):
        """(1, width) tokens, (1,) lengths on the device → ((1,) first
        picked token, the prefilled one-sequence cache)."""
        logits, one = prefill(
            self.model, tokens, self.s_max, kv_dtype=self.kv_dtype, lengths=lengths
        )
        return self._pick(logits), one

    def _pool_step(self, tok):
        """One decode step over the whole slot pool: (slots,) last tokens
        on the device → ((slots,) next tokens, (slots, V) f32 logits). The
        pool's cache advances in place, ``pos`` included: the step graph
        reads and writes the same buffers on every replay, and
        :func:`_merge_slot` writes into them between replays."""
        logits, cache2 = decode_step(self.model, tok, self.cache)
        self.cache.pos.copy_(cache2.pos)
        return self._pick(logits), logits

    def _capture(self, fn, *inputs) -> _Graph:
        """An eager pass of ``fn(*inputs)`` (it fills what later calls
        reuse: K4's launch plans, the libraries' handles), then its
        capture into a CUDA graph on the loop's memory pool. Raises if
        the capture fails (a host sync inside ``fn``, for one)."""
        side_stream_warmup(lambda: fn(*inputs), self.device)
        graph = torch.cuda.CUDAGraph()
        if self.temperature != 0.0:
            # replays draw fresh numbers from the loop's generator
            graph.register_generator_state(self._gen)
        before = {k.name: k.launches for k in KERNELS}
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = fn(*inputs)
        launches = {k.name: k.launches - before.get(k.name, 0) for k in KERNELS}
        self._pool = graph.pool()
        return _Graph(graph, inputs, outputs, launches)

    def _replayed(self, kind: str, g: _Graph) -> None:
        self.replays[kind] += 1
        self.graph_launches.update(g.launches)

    def captured_launches(self) -> dict:
        """The hand kernels' launches one replay of each captured graph
        makes: {"step": {name: n}, "prefill": {width: {name: n}}}."""
        return {
            "step": None if self._step_graph is None else dict(self._step_graph.launches),
            "prefill": {w: dict(g.launches) for w, g in sorted(self._prefill_graphs.items())},
        }

    def _capture_prefill(self, width: int) -> _Graph:
        tokens = torch.zeros((1, width), dtype=torch.long, device=self.device)
        lengths = torch.ones(1, dtype=torch.long, device=self.device)
        g = self._prefill_graphs[width] = self._capture(self._prefill, tokens, lengths)
        _metrics.get_registry().counter("serve_aot_compiled", kind="prefill").inc()
        return g

    def _capture_step(self) -> None:
        # the eager pass writes a position of every slot and advances
        # pos; the written entries are rewritten by the next real step
        # (a step writes its position before attention reads it), and pos
        # is put back, so warm() leaves the pool as it found it
        pos = self.cache.pos.clone()
        tok = torch.zeros(self.slots, dtype=torch.long, device=self.device)
        try:
            self._step_graph = self._capture(self._pool_step, tok)
        finally:
            self.cache.pos.copy_(pos)
        self._tok_host = torch.zeros(self.slots, dtype=torch.long, pin_memory=True)
        _metrics.get_registry().counter("serve_aot_compiled", kind="decode_pool").inc()

    def _run_prefill(self, padded: np.ndarray, n: int):
        """(first picked token, one-sequence cache) of a padded prompt
        of ``n`` real tokens."""
        if not self._capturable:
            picked, one = self._prefill(
                torch.from_numpy(padded).to(self.device),
                torch.tensor([n], device=self.device),
            )
            return int(picked[0]), one
        g = self._prefill_graphs.get(padded.shape[1])
        if g is None:
            # a width off the bucket ladder: captured once, like the JAX
            # package compiling it on first use
            g = self._capture_prefill(padded.shape[1])
        tokens, lengths = g.inputs
        tokens.copy_(torch.from_numpy(padded))
        lengths.fill_(n)
        g.graph.replay()
        self._replayed("prefill", g)
        picked, one = g.outputs
        return int(picked[0]), one

    def _run_step(self, tok: np.ndarray) -> np.ndarray:
        """(slots,) host tokens → (slots,) next tokens on the host."""
        g = self._step_graph
        if g is None:
            picked, _ = self._pool_step(torch.from_numpy(tok).to(self.device))
            return picked.cpu().numpy()
        self._tok_host.copy_(torch.from_numpy(tok))
        g.inputs[0].copy_(self._tok_host, non_blocking=True)
        g.graph.replay()
        self._replayed("step", g)
        return g.outputs[0].cpu().numpy()

    # ------------------------------------------------------------ submit

    def max_prompt_len(self, max_new: int | None = None) -> int:
        return self.s_max - (max_new or self.default_max_new)

    def submit(self, prompt, max_new: int | None = None, rid: Any = None) -> ServeFuture:
        """Queue one prompt ((n,) ints). Returns the future of its
        generated tokens."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        max_new = max_new or self.default_max_new
        fut = ServeFuture()
        if max_new < 1:
            fut.set_exception(ValueError(f"max_new={max_new}: need >= 1"))
            return fut
        if prompt.size < 1 or prompt.size + max_new > self.s_max:
            fut.set_exception(
                ValueError(
                    f"prompt len {prompt.size} + max_new {max_new} "
                    f"exceeds the pool's s_max={self.s_max}"
                )
            )
            return fut
        with self._work:
            self._queue.append((prompt, max_new, rid, fut, _spans.current()))
            _metrics.get_registry().counter("serve_decode_requests").inc()
            self._work.notify()
        return fut

    # -------------------------------------------------------------- step

    @torch.inference_mode()
    def _admit(self) -> None:
        """Prefill queued prompts into free slots (host-side schedule)."""
        reg = _metrics.get_registry()
        while True:
            with self._lock:
                if not self._queue:
                    return
                free = next((b for b, s in enumerate(self._slots) if s is None), None)
                if free is None:
                    return
                prompt, max_new, rid, fut, ctx = self._queue.popleft()
            width = next(
                (w for w in self.prefill_buckets if w >= prompt.size),
                self.prefill_buckets[-1],
            )
            width = max(width, prompt.size)
            padded = np.zeros((1, width), np.int64)
            padded[0, : prompt.size] = prompt
            span_log = _spans.active_span_log()
            t_pre0 = time.perf_counter()
            tok0, one = self._run_prefill(padded, prompt.size)
            seq = _Sequence(rid, max_new, fut, ctx=ctx)
            if span_log is not None:
                # slot-span scaffolding: the generation span's ids are
                # allocated NOW so the prefill can parent on it, but the
                # span itself is recorded at retire (when its wall is
                # known)
                seq.gen_ctx = _spans.make_context(ctx)
                span_log.record_span(
                    "decode.prefill",
                    wall_s=time.perf_counter() - t_pre0,
                    bucket="compute",
                    parent=seq.gen_ctx,
                    rid=rid,
                    width=width,
                    slot=free,
                )
            seq.tokens.append(tok0)
            seq.remaining = max_new - 1
            self.tokens_out += 1
            with self._lock:
                _merge_slot(self.cache, one, free)
                self._tok[free] = tok0
                self._slots[free] = seq
            reg.counter("serve_decode_prefills").inc()
            if seq.remaining == 0 or (self.eos_id is not None and tok0 == self.eos_id):
                self._retire(free)

    def _retire(self, slot: int) -> None:
        with self._lock:
            seq, self._slots[slot] = self._slots[slot], None
        if seq is not None:
            _metrics.get_registry().counter("serve_decode_finished").inc()
            seq.future.set_result(np.asarray(seq.tokens, np.int32))
            wall = time.perf_counter() - seq.submitted
            # one source="serve" stream row per finished generation —
            # the serving panel's decode line (one global read when no
            # telemetry sink is active)
            steplog = _telemetry.active_step_log()
            if steplog is not None:
                steplog.record(
                    "serve",
                    kind="decode",
                    tokens=len(seq.tokens),
                    wall_s=round(wall, 6),
                    slots=self.slots,
                )
            # the slot span: submit→retire wall of this generation, with
            # the admit-time prefill as its child (gen_ctx was
            # pre-allocated at admit)
            if seq.gen_ctx is not None:
                span_log = _spans.active_span_log()
                if span_log is not None:
                    span_log.record_span(
                        "serve.generate",
                        wall_s=wall,
                        parent=seq.ctx,
                        ctx=seq.gen_ctx,
                        rid=seq.rid,
                        tokens=len(seq.tokens),
                        slot=slot,
                    )

    @torch.inference_mode()
    def step(self) -> int:
        """Admit + one pooled decode step. Returns the number of active
        slots that advanced (0 = pool idle). On the card the first step
        captures the graphs if :meth:`warm` has not."""
        if self._capturable and self._step_graph is None:
            self.warm()
        self._admit()
        with self._lock:
            active = [b for b, s in enumerate(self._slots) if s is not None]
            tok = self._tok.copy()
        if not active:
            return 0
        t = self._run_step(tok)
        finished: list[int] = []
        with self._lock:
            for b in active:
                seq = self._slots[b]
                if seq is None:
                    continue
                tb = int(t[b])
                self._tok[b] = tb
                seq.tokens.append(tb)
                seq.remaining -= 1
                self.tokens_out += 1
                if seq.remaining == 0 or (self.eos_id is not None and tb == self.eos_id):
                    finished.append(b)
        for b in finished:
            self._retire(b)
        reg = _metrics.get_registry()
        reg.counter("serve_decode_steps").inc()
        reg.counter("serve_decode_tokens").inc(len(active))
        reg.gauge("serve_slots_active").set(float(len(active)))
        reg.gauge("serve_slot_fill").set(len(active) / self.slots)
        self.occupancy_steps += len(active)
        return len(active)

    # ------------------------------------------------------------ drivers

    def pending(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(s is not None for s in self._slots)

    def run(self, prompts: Sequence[Any], max_new: int | None = None) -> list:
        """Submit every prompt, drive steps until all resolve, return the
        generated token arrays in submit order."""
        futs = [self.submit(p, max_new=max_new) for p in prompts]
        while not all(f.done() for f in futs):
            if self.step() == 0 and not self.pending():
                break
        return [f.result(timeout=0) for f in futs]

    def worker(self, stop: threading.Event, idle_wait_s: float = 0.05) -> None:
        """Server decode thread: step while there is work, park on the
        condition when idle, exit when ``stop`` is set (draining what is
        already in flight first — the SIGTERM contract)."""
        while True:
            if self.step():
                continue
            if stop.is_set():
                if not self.pending():
                    return
                continue
            with self._work:
                if not self._queue and not any(s is not None for s in self._slots):
                    self._work.wait(timeout=idle_wait_s)

    @torch.inference_mode()
    def warm(self) -> float:
        """Make every program the loop can need ready before traffic
        arrives. On the card: capture each prefill bucket's graph and the
        pooled step's (capture before any serving thread starts: a
        capture fails if another thread uses the card meanwhile). On the
        CPU, or over a gloo model axis: run each path once on a scratch
        cache. Returns wall seconds."""
        t0 = time.perf_counter()
        if self._capturable:
            for width in self.prefill_buckets:
                if width not in self._prefill_graphs:
                    self._capture_prefill(width)
            if self._step_graph is None:
                self._capture_step()
            torch.cuda.synchronize(self.device)
        else:
            scratch = self._empty_cache()
            for width in self.prefill_buckets:
                _, one = self._prefill(
                    torch.zeros((1, width), dtype=torch.long, device=self.device),
                    torch.ones(1, dtype=torch.long, device=self.device),
                )
            _merge_slot(scratch, one, 0)
            logits, _ = decode_step(
                self.model,
                torch.zeros(self.slots, dtype=torch.long, device=self.device),
                scratch,
            )
            self._pick(logits)
        wall = time.perf_counter() - t0
        logger.info(
            "decode pool warm: %d slots, s_max %d, %d prefill bucket(s)%s "
            "in %.2fs", self.slots, self.s_max, len(self.prefill_buckets),
            " captured as CUDA graphs" if self.graphed else "", wall,
        )
        return wall
