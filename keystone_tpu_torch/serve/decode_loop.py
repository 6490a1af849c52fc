"""Continuous batching for LM decode: a fixed slot pool — port of
``keystone_tpu/serve/decode_loop.py``.

The pool holds ``slots`` sequences in one batched cache. Each decode step
advances every active slot together; finished sequences retire (EOS or
length) and queued prompts prefill into freed slots between steps, so
aggregate tokens/s grows with occupancy. Built on the per-row cache
positions of :func:`keystone_tpu_torch.models.lm.decode.decode_step`
(a (B,) ``pos`` tensor): slots join at different times with different
prompt lengths and are never position-aligned.

The pool's cache is written in place: a merge copies a prefilled sequence
into its slot, and each step writes the new position of every slot. The
metrics, span and telemetry hooks of the JAX package come with the
observability slice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from keystone_tpu_torch.models.lm.decode import KVCache, decode_step, pick, prefill
from keystone_tpu_torch.serve.queue import ServeFuture


class _Sequence:
    __slots__ = ("rid", "tokens", "remaining", "future", "submitted")

    def __init__(self, rid, remaining: int, future: ServeFuture):
        self.rid = rid
        self.tokens: list[int] = []
        self.remaining = remaining
        self.future = future
        self.submitted = time.perf_counter()


def _merge_slot(pool: KVCache, one: KVCache, slot: int) -> None:
    """Write a freshly prefilled single-sequence cache into pool slot
    ``slot``, in place."""
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
    Prompts are padded to ``prefill_buckets`` widths, as in the JAX
    package, where each width is one compiled program.
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
            # the ladder covers every admissible prompt length
            buckets, b = [], 8
            while b < s_max:
                buckets.append(b)
                b *= 4
            buckets.append(s_max)
            prefill_buckets = buckets
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.device = model.device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._slots: list[_Sequence | None] = [None] * slots
        self._tok = np.zeros(slots, np.int64)
        self.cache = self._empty_cache()
        self.tokens_out = 0
        self.occupancy_steps = 0  # sum of active slots over steps

    # ------------------------------------------------------------- state

    @torch.inference_mode()
    def _empty_cache(self) -> KVCache:
        m = self.model
        d = m.embed.shape[-1]
        hd = d // m.num_heads
        shape = (len(m.blocks), self.slots, m.kv_heads, self.s_max, hd)
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
            self._queue.append((prompt, max_new, rid, fut))
            self._work.notify()
        return fut

    # -------------------------------------------------------------- step

    @torch.inference_mode()
    def _admit(self) -> None:
        """Prefill queued prompts into free slots (host-side schedule)."""
        while True:
            with self._lock:
                if not self._queue:
                    return
                free = next((b for b, s in enumerate(self._slots) if s is None), None)
                if free is None:
                    return
                prompt, max_new, rid, fut = self._queue.popleft()
            width = next(
                (w for w in self.prefill_buckets if w >= prompt.size),
                self.prefill_buckets[-1],
            )
            width = max(width, prompt.size)
            padded = np.zeros((1, width), np.int64)
            padded[0, : prompt.size] = prompt
            logits, one = prefill(
                self.model, torch.from_numpy(padded).to(self.device), self.s_max,
                kv_dtype=self.kv_dtype, lengths=torch.tensor([prompt.size]),
            )
            tok0 = int(self._pick(logits)[0])
            seq = _Sequence(rid, max_new, fut)
            seq.tokens.append(tok0)
            seq.remaining = max_new - 1
            self.tokens_out += 1
            with self._lock:
                _merge_slot(self.cache, one, free)
                self._tok[free] = tok0
                self._slots[free] = seq
            if seq.remaining == 0 or (self.eos_id is not None and tok0 == self.eos_id):
                self._retire(free)

    def _retire(self, slot: int) -> None:
        with self._lock:
            seq, self._slots[slot] = self._slots[slot], None
        if seq is not None:
            seq.future.set_result(np.asarray(seq.tokens, np.int32))

    @torch.inference_mode()
    def step(self) -> int:
        """Admit + one pooled decode step. Returns the number of active
        slots that advanced (0 = pool idle)."""
        self._admit()
        with self._lock:
            active = [b for b, s in enumerate(self._slots) if s is not None]
            tok = torch.from_numpy(self._tok.copy()).to(self.device)
            cache = self.cache
        if not active:
            return 0
        logits, cache2 = decode_step(self.model, tok, cache)
        t = self._pick(logits).cpu().numpy()
        finished: list[int] = []
        with self._lock:
            self.cache = cache2
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
        already in flight first)."""
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
        """Run every path the loop can take once — each prefill bucket, a
        merge and a pooled step, on a scratch cache — before traffic
        arrives, so the kernels are built and the libraries initialized.
        Returns wall seconds."""
        t0 = time.perf_counter()
        scratch = self._empty_cache()
        for width in self.prefill_buckets:
            logits, one = prefill(
                self.model,
                torch.zeros((1, width), dtype=torch.long, device=self.device),
                self.s_max, kv_dtype=self.kv_dtype, lengths=torch.tensor([1]),
            )
        _merge_slot(scratch, one, 0)
        self._pick(logits)
        logits, _ = decode_step(
            self.model,
            torch.zeros(self.slots, dtype=torch.long, device=self.device),
            scratch,
        )
        self._pick(logits).cpu()
        return time.perf_counter() - t0
