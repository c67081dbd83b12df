"""Serving engines of the port: the static-batch baseline and continuous
batching over the slot pool or the paged KV pool (the reference's
``serve/engine.py``).

``StaticEngine`` prefills a whole batch at once (monolithic prefill; on
the card its attention is the flash kernel) and decodes every row in
lockstep until all are done. It stays the parity and throughput
baseline.

``ContinuousEngine`` interleaves prefill and decode micro-steps. Each
host micro-step admits requests from the cell-queue scheduler
(:mod:`repro_torch.serve.scheduler`), deposits prompt material, then
advances every decoding row by one token in one decode call over all
rows. Two KV layouts:

* ``kv_layout="slot"`` (the default, as in the reference): a fixed pool
  of per-request slots (:class:`SlotKVCache`). With ``prefill_chunk > 0``
  prompts stream in chunk by chunk: up to ``max_prefill_per_step``
  chunk-rows are gathered from their slots, advanced by one fused
  :func:`prefill_chunk` call and scattered back. With
  ``prefill_chunk=0`` each admitted prompt is prefilled whole
  (:func:`prefill`, the flash kernel on the card) and inserted into its
  slot. Decode is :func:`decode_step` over the whole pool.
* ``kv_layout="paged"``: a global pool of KV blocks leased through
  per-request block tables (:class:`PagedKVCache`); admission also gates
  on free blocks, chunks deposit through the tables
  (:func:`prefill_chunk_paged`, the multi-query paged-attention kernel)
  and decode reads through them (:func:`decode_step_paged`, the decode
  kernel).

The SSM and hybrid families carry recurrent state per row (the model's
conv/ssm leaves in either pool), the encoder-decoder its cross K/V: the
engine follows the reference's capability checks (``Capabilities``: a
chunk is floored to ``chunk_multiple`` and raises when nothing is left;
a path the family lacks raises with its reason), hands the paged chunk
step each job's request row (``rows``, on the host), and prices the
state in admission (``_carried_state_bytes``). An encoder-decoder
request's encoder runs once at paged admission
(``model.encode_prechunk``), installing its cross K/V into its row
before the decoder chunk stream; on the slot layout it runs inside the
monolithic prefill. A request carries its frontend's inputs beside its
tokens (``frames``, ``patch_embeds``); with the patch_stub frontend the
sequence in the cache is ``num_frontend_tokens`` longer than the prompt.

Rows that are free or still prefilling ride along in decode parked (a
far-negative position): they write nothing visible, keep their carried
state, and their logits are dropped. The caches are updated in place by
the model's steps. Sampling is greedy ``argmax``; a request with
``temperature > 0`` draws from its own ``torch.Generator`` seeded from
``(seed, rid)`` — deterministic within the port, not the reference's
bits. Each micro-step reads the sampled tokens back once; on the paged
layout every forward adds one more sync of its own (the write-target
selection of ``transformer._write_targets``).

Two features of the paged layout (dense family only; the SSM and hybrid
families forbid both through their capabilities):

* ``prefix_cache=True``: a radix index over the pool's blocks
  (:mod:`repro_torch.serve.prefix_cache`). Admission leases every cached
  block of the prompt's longest cached prefix at refcount + 1, clones a
  partially matching block (copy-on-write, ``model.clone_paged_block``,
  in place on the current stream before the chunk that resumes in it),
  and starts the chunked deposit at the first miss, mid-block if need
  be. ``reset(preserve_prefix=True)`` keeps the index for a warm run.
* ``speculate=k``: a drafter (the target itself unless ``draft_model``
  is given) proposes k tokens a round on its own paged pool, leased in
  lockstep with the target's rows; the target checks them in one
  (k+1)-query verify dispatch and keeps the longest matching prefix plus
  its own next token, so greedy output equals plain decoding token for
  token. A round is the drafter's width-2 resync, k - 1 drafter decode
  steps and the verify, run eagerly, with one read-back of the emitted
  tokens (the reference fuses the round into one jit and one sync);
  ``_write_targets`` adds k + 1 more syncs a round, one a forward.
  Rejected draft rows roll back structurally: the row advances by the
  accepted count only.

With ``comm=`` a continuous engine takes four streams of that
communicator, ``prefill``, ``decode``, ``draft`` and ``verify``
(:class:`repro_torch.core.comm.CommStream`), and threads the pool
through each stream's ``ordered`` at the reference's sites: after every
write of the pool (encoder pre-chunk, CoW clone, prompt chunk, the
drafter's chunk, a speculative round), before the decode step, and the
monolithic prefill's cache before its insert. As in the reference the
streams only order values: every dispatch stays on the current stream,
so a bound engine's tokens, admissions, tables and pool equal the
unbound one's bit for bit. Without a comm the streams are
:class:`_NullStream`. Each cache's ``swap_buffers`` checks that what
comes back is its own pool (the steps write it in place).

Telemetry (``REPRO_TRACE=1``, :mod:`repro_torch.obs`), as in the
reference: each micro-step sets the tracer's runnable hint; admissions
are ``hop:admission`` (or ``hop:prefix_hit``) spans priced by the
scheduler's ``admit_cost_s``; prompt chunks, decode steps and
speculative rounds are ``prefill_chunk`` (``jobs``), ``decode``
(``rows``) and ``spec_round`` spans, a round's dispatch a
``hop:spec_verify`` priced by ``protocol.speculative_verify_latency``;
``reset`` flushes the trial (:func:`repro_torch.obs.flush_trial`). A
span is host wall clock around the call. The port adds to the
reference's events: ``prefill_chunk`` and ``decode`` carry ``step``
(:attr:`ContinuousEngine.n_steps`, shared by every span of the step)
and their device time (``device_ms`` on the card, see
:mod:`repro_torch.obs.trace`), ``prefill_chunk`` its batch's valid
``tokens`` and padded ``positions``, and each has three children of
``cat="phase"``: ``.pack`` (host batch, copies to the card, table
rows), ``.forward`` (the model call(s), the pool's ordering) and
``.sample`` (read-back, bookkeeping, first tokens); a chunked step's
admissions are one ``admit`` phase of its own (host time only). Off,
each site is one global read and a ``None`` check: no clock, no CUDA
event, no profiler range. Two counters run always, as the kernels'
launch counters do: :data:`prefill_positions` and
:data:`prefill_valid_tokens`.

Roles (the serving fabric, :mod:`repro_torch.serve.fabric`): a
``role="prefill"`` engine (paged only) leases blocks for the prompt alone,
never decodes, and parks each prefill-complete request in
``ready_handoffs`` (:class:`KVHandoff`) with its rows and blocks still
leased; a ``role="decode"`` engine takes such a request in through
:meth:`ContinuousEngine.begin_import` (a full-budget lease: the posted
receive), the transport's block copies, then
:meth:`ContinuousEngine.finish_import`, which installs the row's host
decode state (next token, position, temperature and the request's own
``torch.Generator`` object, so a sampled stream continues where it
stopped). ``role="full"`` is the single engine. Prefix caching and
speculation need ``role="full"``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.obs import flush_trial as _obs_flush_trial
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import active as _tr_active
from repro_torch.serve.block_pool import PagedKVCache
from repro_torch.serve.kv_cache import SlotError, SlotKVCache
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import CellQueueScheduler, ServeRequest

#: parked decode position: so far below zero that a free or prefilling
#: row's decode writes nothing and reads no token
PARK_POS = -(2 ** 30)

#: token positions the prompt-chunk batches ran (rows x chunk, padding
#: included), and the valid prompt tokens among them, since import; both
#: bumped under the kernels' count lock (``kernels._build.count_lock``)
prefill_positions = 0
prefill_valid_tokens = 0

_NO_SPAN = contextlib.nullcontext()


def _count_chunk(positions: int, valid: int) -> None:
    global prefill_positions, prefill_valid_tokens
    with _build.count_lock:
        prefill_positions += positions
        prefill_valid_tokens += valid


def _phase(tr, name: str, device):
    """A phase of an engine step: a device-timed span of ``cat="phase"``
    while tracing, else a context that does nothing."""
    if tr is None:
        return _NO_SPAN
    return tr.span(name, cat="phase", device=device)


class _NullStream:
    """Stand-in when no communicator is bound: no ordering constraints."""

    def ordered(self, value):
        return value


def _check_device(device, model) -> torch.device:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"engine device {dev} != model device "
                         f"{model.device}")
    return dev


def _generator(seed: int, rid: int, temperature: float,
               device) -> Optional[torch.Generator]:
    """The row's own sampling generator, seeded from ``(seed, rid)``;
    None for a greedy row."""
    if temperature <= 0.0:
        return None
    state = np.random.SeedSequence([seed, rid]).generate_state(1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def frontend_inputs(batch, device) -> dict:
    """A request batch's frontend inputs (everything but ``tokens``:
    ``frames``, ``patch_embeds``) as tensors on ``device``, keyword
    arguments of ``model.prefill`` by name."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in batch.items() if k != "tokens"}


def sequence_len(cfg, prompt_len: int) -> int:
    """Tokens a prompt occupies in the cache: the patch_stub frontend
    prepends ``num_frontend_tokens``."""
    if cfg.frontend == "patch_stub":
        return prompt_len + cfg.num_frontend_tokens
    return prompt_len


def _sample(logits, temps, gens) -> np.ndarray:
    """Greedy argmax per row; rows with ``temps > 0`` draw from their own
    generator instead. logits (R, Vp) -> (R,) int64 on the host (the
    step's one host sync)."""
    nxt = logits.argmax(dim=-1)
    for i, t in enumerate(temps):
        if t > 0.0:
            probs = torch.softmax(logits[i] / max(float(t), 1e-6), -1)
            nxt[i] = torch.multinomial(probs, 1, generator=gens[i])[0]
    return nxt.cpu().numpy()


class StaticEngine:
    """Fixed-batch engine: one prefill, lockstep decode, done-masking."""

    def __init__(self, model, params, cache_len: int, eos_id: int = -1, *,
                 device="cuda"):
        self.device = _check_device(device, model)
        self.model = model
        self.params = params
        self.cache_len = int(cache_len)
        self.eos_id = eos_id

    def generate(self, batch, max_new_tokens: int, *, temperature=0.0,
                 seed: int = 0) -> np.ndarray:
        """batch: ``{"tokens": (B, S)}`` prompts of one length (and the
        frontend's inputs, ``frames`` or ``patch_embeds``). Returns
        (B, max_new) tokens. Rows finished early emit ``eos_id``; an
        all-done batch exits the loop. ``temperature`` is a scalar or a
        per-row (B,) vector; row ``i`` samples from its own generator
        seeded from ``(seed, i)``. The decode step after the last emitted
        token, whose logits nothing reads, is not run."""
        tokens = np.asarray(batch["tokens"])
        B = tokens.shape[0]
        prompt_len = sequence_len(self.model.cfg, tokens.shape[1])
        temps = np.asarray(temperature, np.float32)
        if temps.ndim == 0:
            temps = np.full((B,), float(temps), np.float32)
        elif temps.shape != (B,):
            raise ValueError(f"temperature must be scalar or ({B},), got "
                             f"shape {temps.shape}")
        dev = self.device
        gens = [_generator(seed, i, float(t), dev) for i, t in
                enumerate(temps)]
        logits, cache = self.model.prefill(
            self.params, torch.tensor(tokens, device=dev), self.cache_len,
            **frontend_inputs(batch, dev))
        fill = self.eos_id if self.eos_id >= 0 else 0
        out = np.full((B, max_new_tokens), fill, np.int32)
        done = np.zeros((B,), bool)
        tok = _sample(logits, temps, gens)
        for t in range(max_new_tokens):
            out[:, t] = np.where(done, self.eos_id, tok)
            if self.eos_id >= 0:
                done |= out[:, t] == self.eos_id
                if done.all():
                    break
            if t + 1 == max_new_tokens:
                break
            pos = torch.full((B,), prompt_len + t, dtype=torch.int64,
                             device=dev)
            logits = self.model.decode_step(
                self.params, cache, torch.as_tensor(tok[:, None]).to(dev),
                pos)
            tok = _sample(logits, temps, gens)
        return out


@dataclass(eq=False)      # identity equality: deque.remove must never
class _PrefillJob:        # field-compare requests (ndarray __eq__ raises)
    """A partially-deposited prompt: ``off`` tokens landed so far."""
    req: ServeRequest
    slot: int
    tokens: np.ndarray            # (prompt_len,) int32
    off: int = 0


@dataclass(eq=False)
class KVHandoff:
    """A prefill-complete request ready to migrate to a decode rank: its
    row still holds the prompt's KV blocks and the first token's decode
    state. The owning engine keeps the lease until
    :meth:`ContinuousEngine.release_handoff`: the source blocks must not
    be recycled while the transport still copies out of them."""
    req: ServeRequest
    slot: int                     # source request row
    out: np.ndarray               # (max_new,) output buffer, out[0] = tok0
    length: int                   # resident prompt tokens
    blocks: List[int]             # source pool block ids, table order


class ContinuousEngine:
    """Continuous-batching engine: slot-pool or paged-pool decode +
    cell-queue admission + chunked, batched (or monolithic) prefill.

    ``step(now)`` is one micro-step; drive it from a traffic loop (see
    ``repro_torch.launch.serve``) or use :meth:`generate` for a
    same-arrival batch."""

    def __init__(self, model, params, *, cache_len: int, num_slots: int,
                 eos_id: int = -1,
                 scheduler: Optional[CellQueueScheduler] = None,
                 comm=None, max_prefill_per_step: int = 1,
                 prefill_chunk: int = 64,
                 kv_layout: str = "slot", block_size: int = 16,
                 num_blocks: Optional[int] = None, role: str = "full",
                 prefix_cache: bool = False, speculate: int = 0,
                 draft_model=None, draft_params=None, device="cuda"):
        dev = _check_device(device, model)
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r} "
                             "(expected 'slot' or 'paged')")
        if role not in ("full", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r} "
                             "(expected 'full', 'prefill' or 'decode')")
        if role == "prefill" and kv_layout != "paged":
            raise ValueError("a prefill-rank engine hands its KV off "
                             "block-by-block; it requires kv_layout='paged'")
        #: fabric role: "prefill" leases the prompt only, never decodes and
        #: parks finished prefills in ready_handoffs; "decode" takes
        #: requests in through begin_import / finish_import; "full" is
        #: the single engine
        self.role = role
        self.model = model
        self.params = params
        self.device = dev
        self.cache_len = int(cache_len)
        self.eos_id = eos_id
        self.kv_layout = kv_layout
        self.max_prefill_per_step = max(1, int(max_prefill_per_step))
        #: structural serving capabilities (registry.derive_capabilities)
        self.capabilities = caps = model.capabilities
        chunk = int(prefill_chunk) if prefill_chunk else 0
        if chunk:
            # a family that cannot chunk on this layout raises, naming the
            # missing capability (never a silent monolithic fallback)
            has_chunk = (model.prefill_chunk_paged if kv_layout == "paged"
                         else model.prefill_chunk)
            if has_chunk is None:
                missing = ("chunked_prefill" if not caps.chunked_prefill
                           else "slot_chunk")
                hint = (" — this family chunks on the paged path only; "
                        "use kv_layout='paged'"
                        if caps.chunked_prefill and kv_layout == "slot"
                        else "")
                why = f" ({caps.reason})" if caps.reason else ""
                raise ValueError(
                    f"model lacks capability {missing!r} for chunked "
                    f"prefill on the {kv_layout} layout{hint}{why}; pass "
                    "prefill_chunk=0 for explicit monolithic prefill")
            chunk = min(chunk, self.cache_len)
            mult = int(caps.chunk_multiple)
            if mult > 1:
                # recurrent families resume bit-exactly only when chunk
                # boundaries fall on ssm_chunk multiples: clamp down
                chunk = (chunk // mult) * mult
                if chunk == 0:
                    raise ValueError(
                        f"prefill_chunk={prefill_chunk} (after the "
                        f"cache_len={cache_len} clamp) is below this "
                        f"family's chunk_multiple={mult}; chunk boundaries "
                        f"must fall on multiples of {mult} for bit-exact "
                        "recurrent-state resume")
        #: 0 = monolithic prefill (slot layout only)
        self.prefill_chunk = chunk
        paged = kv_layout == "paged"
        if paged:
            if model.decode_step_paged is None:
                why = f": {caps.reason}" if caps.reason else ""
                raise ValueError(
                    "model lacks capability 'paged_decode' — no "
                    f"block-table paged decode path{why}")
            if not self.prefill_chunk:
                raise ValueError("paged KV deposits prompts chunk-by-chunk;"
                                 " prefill_chunk must be > 0")
            # equal-HBM default: the token capacity a slot pool would
            # reserve, repartitioned into leased blocks
            mbr = -(-self.cache_len // int(block_size))
            nblocks = (int(num_blocks) if num_blocks
                       else -(-num_slots * self.cache_len // int(block_size)))
            self.kv = PagedKVCache(model, num_blocks=nblocks,
                                   block_size=int(block_size),
                                   num_slots=num_slots,
                                   max_blocks_per_req=mbr)
        else:
            self.kv = SlotKVCache(model, self.cache_len, num_slots)
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache:
            if not paged:
                raise ValueError("prefix caching shares paged KV blocks; "
                                 "it requires kv_layout='paged'")
            if role != "full":
                raise ValueError("prefix caching is not supported on "
                                 "disaggregated prefill/decode ranks "
                                 "(migrated blocks leave the local pool)")
            if not caps.prefix_cache:
                raise ValueError("model lacks capability 'prefix_cache': "
                                 + caps.reason)
            # the radix index is the pool's reclaimer (LRU eviction of
            # parked blocks)
            self.prefix_cache = PrefixCache(self.kv.pool)
        self.speculate = int(speculate)
        if self.speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if self.speculate:
            self._init_drafter(draft_model, draft_params, num_slots)
        self.scheduler = scheduler or CellQueueScheduler(
            num_cells=4 * num_slots,
            prefill_chunk_bytes=4 * self.prefill_chunk,
            block_bytes=4 * int(block_size) if paged else 0,
            state_bytes=self._carried_state_bytes())
        if comm is not None:
            self._prefill_stream = comm.stream("prefill")
            self._decode_stream = comm.stream("decode")
            # draft and verify are distinct execution domains (the
            # drafter's pool advances independently of the target's)
            self._draft_stream = comm.stream("draft")
            self._verify_stream = comm.stream("verify")
        else:
            self._prefill_stream = _NullStream()
            self._decode_stream = _NullStream()
            self._draft_stream = _NullStream()
            self._verify_stream = _NullStream()
        #: partially-deposited requests, FIFO; each micro-step serves the
        #: first ``max_prefill_per_step`` of them with one fused dispatch
        self._prefilling: Deque[_PrefillJob] = deque()
        #: role="prefill": prefill-complete requests awaiting migration
        #: (their rows and blocks stay leased until release_handoff)
        self.ready_handoffs: List[KVHandoff] = []
        self._fresh_state()
        self._zero_accounting()

    def _zero_accounting(self) -> None:
        self.peak_live = 0
        self._resident_tok_sum = 0
        self._reserved_tok_sum = 0
        # prefix-cache accounting (zero when the cache is off): hit tokens
        # never re-prefill, so saved tokens == hit tokens, and saved
        # dispatches is the per-request chunk-count difference
        self.prefix_lookups = self.prefix_hits = 0
        self.prefix_hit_tokens = self.prefix_prompt_tokens = 0
        self.prefill_dispatches_saved = self.prefix_cow_clones = 0
        #: draft-verify rounds run (each: one resync and one verify
        #: forward, k - 1 drafter decode steps)
        self.spec_rounds = 0
        #: micro-steps run: the ``step`` of every span a step emits
        self.n_steps = 0

    def _init_drafter(self, draft_model, draft_params, num_slots) -> None:
        """The reference's checks on speculation, then the drafter's own
        paged pool, with the target's geometry so rows and leases stay
        one to one (alloc and free in lockstep)."""
        model = self.model
        if self.kv_layout != "paged":
            raise ValueError("speculative decoding rolls rejected draft KV "
                             "back through block tables; it requires "
                             "kv_layout='paged'")
        if self.role != "full":
            raise ValueError("speculative decoding needs draft and verify on "
                             "one engine; it is not supported on "
                             "disaggregated prefill/decode ranks")
        if self.prefix_cache is not None:
            raise ValueError(
                "speculative decoding does not compose with prefix "
                "caching: rolled-back draft rows would sit inside blocks "
                "the radix cache could lease to another request as "
                "canonical prefix KV")
        if not self.capabilities.speculative:
            raise ValueError("model lacks capability 'speculative': "
                             + self.capabilities.reason)
        if draft_model is None:
            # self-speculation: the target drafts for itself on a second
            # pool (the whole draft-verify-rollback machinery, near-1.0
            # acceptance)
            draft_model, draft_params = model, self.params
        else:
            if draft_params is None:
                raise ValueError("draft_model needs draft_params")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"drafter vocab {draft_model.cfg.vocab_size} != target "
                    f"vocab {model.cfg.vocab_size}: drafted token ids "
                    "would not index the target's distribution")
            if not draft_model.capabilities.speculative:
                raise ValueError("draft model lacks capability "
                                 "'speculative': "
                                 + draft_model.capabilities.reason)
            if draft_model.device != self.device:
                raise ValueError(f"draft model device {draft_model.device} "
                                 f"!= engine device {self.device}")
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.draft_kv = PagedKVCache(
            draft_model, num_blocks=self.kv.pool.num_blocks,
            block_size=self.kv.block_size, num_slots=num_slots,
            max_blocks_per_req=self.kv.max_blocks_per_req)
        #: tokens of each row the drafter's pool holds (canonical ones)
        self._draft_len = np.zeros((num_slots,), np.int64)

    def _carried_state_bytes(self) -> int:
        """Per-request bytes of carried (non-KV) state: the scheduler
        prices one extra interthread handoff per admission for it (the
        state row travels with the request, unlike pool-resident KV)."""
        caps = self.capabilities
        if not caps.carried_state:
            return 0
        buf = self.kv.buffers
        total = sum(t.numel() * t.element_size()
                    for name, t in buf.items() if name in caps.state_leaves)
        return int(total) // max(1, self.kv.num_slots)

    def _fresh_state(self) -> None:
        """Per-row decode state, on the host: next input token, next
        position (parked rows at PARK_POS), temperature and generator."""
        S = self.kv.num_slots
        self._tok = np.zeros((S,), np.int64)
        self._pos = np.full((S,), PARK_POS, np.int64)
        self._temp = np.zeros((S,), np.float32)
        self._gen: List[Optional[torch.Generator]] = [None] * S
        self._slot_req: List[Optional[ServeRequest]] = [None] * S
        self._slot_out: List[Optional[np.ndarray]] = [None] * S

    def _generator(self, req: ServeRequest) -> Optional[torch.Generator]:
        return _generator(req.seed, req.rid, req.temperature, self.device)

    # -- request intake ----------------------------------------------------
    def submit(self, req: ServeRequest, now: float = 0.0) -> str:
        """Queue a request through the cell-queue scheduler. A paged
        request whose token budget can never fit its block table or the
        pool is rejected here, at submit, as is a sampled request on a
        speculative engine (its acceptance is exact for argmax only)."""
        if self.speculate and req.temperature > 0.0:
            raise ValueError(
                f"request {req.rid}: speculative decoding verifies greedy "
                "token identity (longest-matching-prefix acceptance is "
                "exact for argmax only); temperature must be 0, got "
                f"{req.temperature}")
        if self.kv_layout == "paged":
            budget = self._token_budget(req)
            cap = self.admittable_tokens
            if budget > cap:
                # a prefill-rank lease is prompt-only: the message names
                # the quantity actually rejected
                what = ("prompt" if self.role == "prefill"
                        else "prompt+max_new")
                fix = ("" if self.role == "prefill"
                       else " or lower max_new_tokens")
                raise ValueError(
                    f"request {req.rid}: {what} = {budget} tokens exceeds "
                    f"the admittable capacity {cap} (= min(table cap "
                    f"{self.kv.max_blocks_per_req}, pool "
                    f"{self.kv.pool.num_blocks}) blocks x "
                    f"{self.kv.block_size}); raise cache_len/num_blocks"
                    f"{fix}")
        return self.scheduler.submit(req, now)

    @property
    def admittable_tokens(self) -> int:
        """Largest token budget one request could ever lease: on the paged
        layout it must fit both the per-request table and the whole pool;
        unbounded on the slot layout."""
        if self.kv_layout != "paged":
            return 2 ** 31 - 1
        return (min(self.kv.max_blocks_per_req, self.kv.pool.num_blocks)
                * self.kv.block_size)

    def _token_budget(self, req: ServeRequest) -> int:
        """Tokens leased at admission: the prompt plus every token the
        request may generate (no mid-decode block exhaustion). A
        prefill-rank engine leases the prompt only: every generated
        token's KV is written on the decode rank that imports it."""
        if self.role == "prefill":
            return req.prompt_len
        return req.prompt_len + req.max_new_tokens

    @property
    def num_active(self) -> int:
        return self.kv.num_live

    @property
    def num_prefilling(self) -> int:
        """Requests admitted to a row but still streaming their prompt."""
        return len(self._prefilling)

    @property
    def num_decoding(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def idle(self) -> bool:
        return self.kv.num_live == 0 and self.scheduler.num_waiting == 0

    # -- micro-step --------------------------------------------------------
    def step(self, now: float = 0.0) -> List[ServeRequest]:
        """One serving micro-step: deposit prompt material for up to
        ``max_prefill_per_step`` requests (one chunk each, fused into one
        dispatch; or, with ``prefill_chunk=0``, whole prompts), then
        advance every decoding row by one token. Returns the requests
        that finished this step."""
        self.n_steps += 1
        tr = _tr_active()
        if tr is not None:
            # runnable-work hint for the serialization-stall detector:
            # rows + queued requests this engine could be advancing
            tr.set_runnable(self.kv.num_live + self.scheduler.num_waiting)
        finished: List[ServeRequest] = []
        if self.prefill_chunk:
            budget = min(self.kv.num_free,
                         self.max_prefill_per_step - len(self._prefilling))
            # paged: a request's whole token budget must also fit in free
            # blocks; admit one at a time so each lease is debited before
            # the next candidate is gated. With the prefix cache only the
            # miss tail needs fresh blocks: the gate prices the hit
            can = None
            if self.prefix_cache is not None:
                def can(r):
                    return self.kv.can_admit(self._token_budget(r),
                                             hit=self._prefix_lookup(r))
            elif self.kv_layout == "paged":
                def can(r):
                    return self.kv.can_admit(self._token_budget(r))
            with (_NO_SPAN if tr is None else
                  tr.span("admit", cat="phase", step=self.n_steps)):
                while budget > 0:
                    admitted = self.scheduler.admit(now, 1, can_admit=can)
                    if not admitted:
                        break
                    req = admitted[0]
                    if tr is None:
                        self._begin_prefill(req)
                    else:
                        # the admission hop's wall-clock twin of the price
                        # stamped on the request (repriced to the
                        # prefix-hit model when the radix cache served it)
                        t0 = time.perf_counter()
                        self._begin_prefill(req)
                        tr.hop("prefix_hit" if req.prefix_hit_tokens > 0
                               else "admission", req.admit_cost_s, t0,
                               time.perf_counter(), rid=req.rid)
                    budget -= 1
            if self._prefilling:
                if tr is None:
                    finished.extend(self._prefill_chunk_step(now))
                else:
                    nj = min(len(self._prefilling),
                             self.max_prefill_per_step)
                    with tr.span("prefill_chunk", cat="engine",
                                 device=self.device, step=self.n_steps,
                                 jobs=nj) as sp:
                        finished.extend(self._prefill_chunk_step(now, tr,
                                                                 sp))
        else:
            n_admit = min(self.kv.num_free, self.max_prefill_per_step)
            for req in self.scheduler.admit(now, n_admit):
                if tr is None:
                    done = self._admit(req, now)
                else:
                    t0 = time.perf_counter()
                    done = self._admit(req, now)
                    tr.hop("admission", req.admit_cost_s, t0,
                           time.perf_counter(), rid=req.rid)
                if done is not None:
                    finished.append(done)
        if self.num_decoding:
            if tr is None:
                finished.extend(self._spec_micro_step(now) if self.speculate
                                else self._decode_micro_step(now))
            elif self.speculate:
                t0 = time.perf_counter()
                finished.extend(self._spec_micro_step(now))
                tr.complete("spec_round", t0, time.perf_counter(),
                            cat="engine")
            else:
                with tr.span("decode", cat="engine", device=self.device,
                             step=self.n_steps, rows=self.num_decoding):
                    finished.extend(self._decode_micro_step(now, tr))
        self._account()
        return finished

    def _account(self) -> None:
        live = self.kv.num_live
        self.peak_live = max(self.peak_live, live)
        if live:
            self._resident_tok_sum += int(self.kv.lengths.sum())
            self._reserved_tok_sum += (
                self.kv.resident_capacity_tokens
                if self.kv_layout == "paged" else live * self.cache_len)

    def kv_accounting(self) -> dict:
        """Thin alias: the schema lives in
        :func:`repro_torch.obs.metrics.engine_kv_accounting`."""
        return obs_metrics.engine_kv_accounting(self)

    def prefix_stats(self) -> dict:
        """Thin alias: :func:`repro_torch.obs.metrics.engine_prefix_stats`."""
        return obs_metrics.engine_prefix_stats(self)

    @property
    def decode_tokens_per_dispatch(self) -> float:
        """Tokens one decode dispatch yields: 1.0 without speculation;
        with it, the observed mean accepted per dispatch, or the ``(k +
        2) / 2`` uniform-acceptance prior before any round has run."""
        if not self.speculate:
            return 1.0
        sch = self.scheduler
        if sch.n_spec_dispatches:
            return sch.spec_accepted_tokens / sch.n_spec_dispatches
        return (self.speculate + 2) / 2

    def spec_stats(self) -> dict:
        """Thin alias: :func:`repro_torch.obs.metrics.engine_spec_stats`."""
        return obs_metrics.engine_spec_stats(self)

    # -- prompt deposit ----------------------------------------------------
    def _begin_prefill(self, req: ServeRequest) -> None:
        """Claim a slot (blanked: a chunked deposit appends entries) or
        lease blocks + a request row, and enter ``prefilling``. Paged
        masking is structural (a stale page of a block's previous owner
        is never at a position <= qpos of the new one): no blanking. With
        the prefix cache the deposit starts at the first token the cache
        did not hold; with speculation the drafter's pool leases the same
        row."""
        resident = 0
        if self.kv_layout == "paged":
            if self.prefix_cache is not None:
                slot, resident = self._admit_with_prefix(req)
            else:
                slot = self.kv.alloc(req, self._token_budget(req))
            if self.speculate:
                dslot = self.draft_kv.alloc(req, self._token_budget(req))
                if dslot != slot:
                    raise SlotError(
                        f"drafter row {dslot} diverged from target row "
                        f"{slot} for request {req.rid}: the pools' "
                        "alloc/free lockstep broke")
            if self.model.encode_prechunk is not None:
                # the encoder pre-chunk: this request's cross K/V into its
                # row before the decoder prompt starts streaming
                self.model.encode_prechunk(
                    self.params, self.kv.buffers,
                    frontend_inputs(req.batch, self.device)["frames"],
                    [slot])
                self.kv.swap_buffers(
                    self._prefill_stream.ordered(self.kv.buffers))
        else:
            slot = self.kv.alloc(req)
            self.kv.reset_slot(slot)
        req.state = "prefilling"
        tokens = np.asarray(req.batch["tokens"][0], np.int32)
        self._prefilling.append(_PrefillJob(req=req, slot=slot,
                                            tokens=tokens, off=resident))

    def _prefix_lookup(self, req: ServeRequest):
        """Longest cached prefix of the prompt, one token short of its
        length at most: the final chunk always re-prefills, so its
        last-position logits exist to seed decode."""
        tokens = np.asarray(req.batch["tokens"][0], np.int32)
        return self.prefix_cache.lookup(tokens, limit=len(tokens) - 1)

    def _admit_with_prefix(self, req: ServeRequest):
        """Paged admission through the radix cache: lease every hit block
        at refcount + 1, allocate fresh blocks for the miss tail only,
        clone the partially matching block (CoW) and resume the chunked
        deposit at the first miss. Returns ``(slot, resident)``."""
        hit = self._prefix_lookup(req)
        slot = self.kv.alloc_prefix(req, self._token_budget(req), hit,
                                    self.prefix_cache)
        resident = hit.tokens
        if hit.cow_src is not None:
            # copy the shared block into the request's first private
            # block, in place on the current stream (the chunk resuming
            # in it comes later on the same stream), then drop the
            # temporary source reference
            dst = self.kv.blocks_of(slot)[len(hit.blocks)]
            self.model.clone_paged_block(self.kv.buffers, hit.cow_src, dst)
            self.kv.swap_buffers(self._prefill_stream.ordered(self.kv.buffers))
            self.prefix_cache.release_cow(hit.cow_src)
            resident += hit.cow_tokens
            self.prefix_cow_clones += 1
        if resident:
            self.kv.advance(slot, resident)
        plen = req.prompt_len
        self.prefix_lookups += 1
        self.prefix_prompt_tokens += plen
        if resident:
            C = self.prefill_chunk
            self.prefix_hits += 1
            self.prefix_hit_tokens += resident
            self.prefill_dispatches_saved += (
                -(-plen // C) - -(-(plen - resident) // C))
            req.prefix_hit_tokens = resident
            self.scheduler.reprice_prefix(
                req, resident, cow_blocks=int(hit.cow_src is not None))
        return slot, resident

    def _prefill_chunk_step(self, now: float, tr=None,
                            span=None) -> List[ServeRequest]:
        """One fused dispatch: the next chunk of up to
        ``max_prefill_per_step`` prefilling requests, one row each, padded
        to the chunk length and masked by ``n_valid``. The slot layout
        gathers the rows' slots, advances them and scatters them back; the
        paged layout writes through the block tables. Traced, ``span`` is
        the step's ``prefill_chunk`` span and takes the batch's sizes."""
        C = self.prefill_chunk
        jobs = list(self._prefilling)[:self.max_prefill_per_step]
        n = len(jobs)
        dev = self.device
        with _phase(tr, "prefill_chunk.pack", dev):
            tok = np.zeros((n, C), np.int64)
            slots = np.zeros((n,), np.int64)
            pos0 = np.zeros((n,), np.int64)
            n_valid = np.zeros((n,), np.int64)
            for i, job in enumerate(jobs):
                k = min(C, len(job.tokens) - job.off)
                tok[i, :k] = job.tokens[job.off:job.off + k]
                slots[i] = job.slot
                pos0[i] = job.off
                n_valid[i] = k
                job.req.prefill_chunks += 1
            args = (torch.as_tensor(tok).to(dev),
                    torch.as_tensor(pos0).to(dev),
                    torch.as_tensor(n_valid).to(dev))
            if self.kv_layout == "paged":
                tables = torch.as_tensor(self.kv.table_rows(slots)).to(dev)
                if self.speculate:
                    draft_tables = torch.as_tensor(
                        self.draft_kv.table_rows(slots)).to(dev)
        valid = int(n_valid.sum())
        _count_chunk(n * C, valid)
        if span is not None:
            span.args.update(tokens=valid, positions=n * C)
        with _phase(tr, "prefill_chunk.forward", dev):
            if self.kv_layout == "paged":
                # the rows of the carried state stay on the host: the
                # model decides which state rows to write there, without
                # a sync
                logits = self.model.prefill_chunk_paged(
                    self.params, self.kv.buffers, args[0], tables,
                    torch.as_tensor(slots), *args[1:])
                if self.speculate:
                    # the same chunk into the drafter's pool, through its
                    # own tables; its logits are not needed (the
                    # drafter's first proposal comes from the round's
                    # resync)
                    self.draft_model.prefill_chunk_paged(
                        self.draft_params, self.draft_kv.buffers, args[0],
                        draft_tables, torch.as_tensor(slots), *args[1:])
                    self.draft_kv.swap_buffers(
                        self._draft_stream.ordered(self.draft_kv.buffers))
            else:
                rows = self.kv.rows_at(slots)
                logits = self.model.prefill_chunk(self.params, rows, *args)
                self.kv.rows_into(rows, slots)
            self.kv.swap_buffers(
                self._prefill_stream.ordered(self.kv.buffers))
        with _phase(tr, "prefill_chunk.sample", dev):
            final = []
            for i, job in enumerate(jobs):
                job.off += int(n_valid[i])
                self.kv.advance(job.slot, int(n_valid[i]))  # entries appended
                if job.off >= len(job.tokens):
                    final.append(i)
            finished: List[ServeRequest] = []
            if not final:
                return finished
            gens = [self._generator(jobs[i].req) for i in final]
            tok0 = _sample(logits[final], [jobs[i].req.temperature
                                           for i in final], gens)
            for i, t0, gen in zip(final, tok0, gens):
                job = jobs[i]
                self._prefilling.remove(job)
                if self.speculate:
                    self._draft_len[job.slot] = len(job.tokens)
                if self.prefix_cache is not None:
                    # index the prompt's full blocks before the request
                    # can finish at once (EOS first token) and free them
                    # to parked
                    self.prefix_cache.insert(job.tokens,
                                             self.kv.blocks_of(job.slot))
                done = self._start_decode(job.slot, job.req, int(t0), gen,
                                          now)
                if done is not None:
                    finished.append(done)
            return finished

    def _admit(self, req: ServeRequest, now: float) -> Optional[ServeRequest]:
        """Monolithic admission (slot layout, ``prefill_chunk=0``): prefill
        the whole prompt, insert its cache into a fresh slot and sample the
        first token. Returns the request if it finished at once."""
        tokens = torch.tensor(np.asarray(req.batch["tokens"]),
                              device=self.device)
        logits, cache = self.model.prefill(
            self.params, tokens, self.cache_len,
            **frontend_inputs(req.batch, self.device))
        cache = self._prefill_stream.ordered(cache)
        slot = self.kv.alloc(req)
        self.kv.insert(slot, cache,
                       length=sequence_len(self.model.cfg, req.prompt_len))
        gen = self._generator(req)
        tok0 = int(_sample(logits, [req.temperature], [gen])[0])
        return self._start_decode(slot, req, tok0, gen, now)

    def _start_decode(self, slot: int, req: ServeRequest, tok0: int, gen,
                      now: float) -> Optional[ServeRequest]:
        """Install a freshly-prefilled row's decode state (next token, next
        position, temperature, generator) and its first token."""
        self._tok[slot] = tok0
        # next decode position
        self._pos[slot] = sequence_len(self.model.cfg, req.prompt_len)
        self._temp[slot] = req.temperature
        self._gen[slot] = gen
        return self._install_first_token(slot, req, tok0, now)

    def _install_first_token(self, slot: int, req: ServeRequest, tok0: int,
                             now: float) -> Optional[ServeRequest]:
        """Record the first sampled token and either finish the request
        (EOS first token / max_new == 1) or enter decoding."""
        req.first_token_time = now
        req.state = "decoding"
        fill = self.eos_id if self.eos_id >= 0 else 0
        out = np.full((req.max_new_tokens,), fill, np.int32)
        out[0] = tok0
        req.generated = 1
        if (0 <= self.eos_id == tok0) or req.max_new_tokens == 1:
            return self._finish(slot, req, out, now)
        if self.role == "prefill":
            # the request never enters this engine's decode rows (so no
            # decode step can advance its held state before it ships)
            req.state = "migrating"
            self.ready_handoffs.append(KVHandoff(
                req=req, slot=slot, out=out, length=self.kv.length(slot),
                blocks=self.kv.blocks_of(slot)))
            return None
        self._slot_req[slot] = req
        self._slot_out[slot] = out
        return None

    def _decode_micro_step(self, now: float,
                           tr=None) -> List[ServeRequest]:
        dev = self.device
        paged = self.kv_layout == "paged"
        with _phase(tr, "decode.pack", dev):
            tok = torch.as_tensor(self._tok[:, None]).to(dev)
            pos = torch.as_tensor(self._pos).to(dev)
            if paged:
                tables = self.kv.tables_device()
        with _phase(tr, "decode.forward", dev):
            # the decode step's device-resident state is the pool
            self._decode_stream.ordered(self.kv.buffers)
            if paged:
                logits = self.model.decode_step_paged(
                    self.params, self.kv.buffers, tok, pos, tables)
            else:
                logits = self.model.decode_step(self.params,
                                                self.kv.buffers, tok, pos)
        with _phase(tr, "decode.sample", dev):
            nxt = _sample(logits, self._temp, self._gen)
            finished: List[ServeRequest] = []
            for slot in self.kv.live_slots:
                req = self._slot_req[slot]
                if req is None:    # row still mid-prefill: nothing to read
                    continue
                t = int(nxt[slot])
                out = self._slot_out[slot]
                out[req.generated] = t
                req.generated += 1
                self.kv.advance(slot)
                self._tok[slot] = t
                self._pos[slot] += 1
                if (0 <= self.eos_id == t) \
                        or req.generated >= req.max_new_tokens:
                    finished.append(self._finish(slot, req, out, now))
                    self._slot_req[slot] = None
                    self._slot_out[slot] = None
            return finished

    def _spec_micro_step(self, now: float) -> List[ServeRequest]:
        """The speculative decode micro-step: one draft-verify round over
        every decoding row (:meth:`_spec_round`) in place of up to k + 1
        one-token steps. Per row, ``tpos`` (the target's next write
        position) is its resident length; the canonical context is one
        token longer (the pending token ``cur``); the drafter holds ``u =
        canon - draft_len`` (1 or 2) fewer tokens. ``n_draft`` is clamped
        to ``remaining - 1``, so the budget is never overdrawn: at one
        token left the round is a width-1 verify."""
        k = self.speculate
        S = self.kv.num_slots
        cur = np.zeros((S,), np.int64)
        prev = np.zeros((S,), np.int64)
        u = np.ones((S,), np.int64)
        sync_pos = np.full((S,), PARK_POS, np.int64)
        tpos = np.full((S,), PARK_POS, np.int64)
        n_draft = np.zeros((S,), np.int64)
        live: List[int] = []
        for slot in self.kv.live_slots:
            req = self._slot_req[slot]
            if req is None:        # row still mid-prefill: parked
                continue
            g = req.generated
            out = self._slot_out[slot]
            cur[slot] = out[g - 1]
            prev[slot] = out[g - 2] if g >= 2 else out[g - 1]
            canon = self.kv.length(slot) + 1
            u[slot] = canon - int(self._draft_len[slot])
            sync_pos[slot] = canon - u[slot]
            tpos[slot] = canon - 1
            n_draft[slot] = min(k, req.max_new_tokens - g - 1)
            live.append(slot)
        tr = _tr_active()
        t_disp = time.perf_counter() if tr is not None else 0.0
        greedy, n_emit = self._spec_round(cur, prev, u, sync_pos, tpos,
                                          n_draft)
        self.kv.swap_buffers(self._verify_stream.ordered(self.kv.buffers))
        self.draft_kv.swap_buffers(
            self._draft_stream.ordered(self.draft_kv.buffers))
        self.spec_rounds += 1
        cost = protocol.speculative_verify_latency(k)
        if tr is not None:
            # the round's modeled price is per live row; the measured twin
            # is the round's dispatches and its one read-back
            tr.hop("spec_verify", cost * max(1, len(live)), t_disp,
                   time.perf_counter(), rows=len(live), k=k)
        finished: List[ServeRequest] = []
        for slot in live:
            req = self._slot_req[slot]
            out = self._slot_out[slot]
            g = req.generated
            ne = int(n_emit[slot])
            em = greedy[slot, :ne]
            keep = ne
            if self.eos_id >= 0:
                hits = np.nonzero(em == self.eos_id)[0]
                if hits.size:                  # truncate at the first EOS
                    keep = int(hits[0]) + 1
            out[g:g + keep] = em[:keep]
            req.generated = g + keep
            # the drafter now holds canon + min(n_emit - 1, k - 1) tokens
            canon = self.kv.length(slot) + 1
            self._draft_len[slot] = canon + min(ne - 1, k - 1)
            self.kv.advance(slot, keep)        # accepted rows only
            self.scheduler.record_spec_dispatch(keep, int(n_draft[slot]),
                                                ne - 1, cost)
            if (self.eos_id >= 0 and em[keep - 1] == self.eos_id) \
                    or req.generated >= req.max_new_tokens:
                finished.append(self._finish(slot, req, out, now))
                self._slot_req[slot] = None
                self._slot_out[slot] = None
        return finished

    def _spec_round(self, cur, prev, u, sync_pos, tpos, n_draft):
        """One draft-verify round on the device, from host inputs (S,):
        the drafter resyncs with a width-2 teacher-forced dispatch of the
        ``u`` canonical tokens it lacks, whose last valid row gives draft
        1; k - 1 drafter decode steps extend the proposal (a step past a
        row's ``n_draft`` parks its write); the target verifies ``[cur,
        d_1 .. d_k]`` in one dispatch; the longest matching prefix plus
        the target's own token is what sequential greedy decoding would
        emit. Returns ``(greedy (S, k+1), n_emit (S,))`` on the host:
        the round's one read-back."""
        k = self.speculate
        dev = self.device

        def on(a):
            return torch.as_tensor(a).to(dev)

        sync_tok = np.where((u == 2)[:, None], np.stack([prev, cur], 1),
                            np.stack([cur, cur], 1))
        dtables = self.draft_kv.tables_device()
        dlogits = self.draft_model.verify_step_paged(
            self.draft_params, self.draft_kv.buffers, on(sync_tok),
            on(sync_pos), dtables, on(u))
        rows = torch.arange(len(u), device=dev)
        drafts = [dlogits.argmax(-1)[rows, on(np.maximum(u - 1, 0))]]
        base = sync_pos + u                # the drafter's next position
        for j in range(k - 1):
            pos_j = np.where(j + 1 <= n_draft, base + j, PARK_POS)
            lg = self.draft_model.decode_step_paged(
                self.draft_params, self.draft_kv.buffers,
                drafts[-1][:, None], on(pos_j), dtables)
            drafts.append(lg.argmax(-1))
        drafts = torch.stack(drafts, 1)                         # (S, k)
        nd = on(n_draft)
        logits = self.model.verify_step_paged(
            self.params, self.kv.buffers,
            torch.cat([on(cur)[:, None], drafts], 1), on(tpos),
            self.kv.tables_device(), nd + 1)
        greedy = logits.argmax(-1)                              # (S, k+1)
        match = ((drafts == greedy[:, :k])
                 & (torch.arange(k, device=dev)[None, :] < nd[:, None]))
        n_emit = match.long().cumprod(1).sum(1) + 1
        both = torch.cat([greedy, n_emit[:, None]], 1).cpu().numpy()
        return both[:, :k + 1], both[:, k + 1]

    def _finish(self, slot: int, req: ServeRequest, out: np.ndarray,
                now: float) -> ServeRequest:
        req.output = out
        self.kv.free(slot)
        if self.speculate:
            self.draft_kv.free(slot)       # lockstep with the target row
            self._draft_len[slot] = 0
        # park the freed row so later decode steps write nothing for it
        self._pos[slot] = PARK_POS
        self._temp[slot] = 0.0
        self._gen[slot] = None
        self.scheduler.record_finish(req, now)
        return req

    # -- disaggregated KV handoff (the fabric's transport surface) ---------
    def take_handoffs(self) -> List[KVHandoff]:
        """Drain the prefill-complete requests awaiting migration. The
        caller gets each one to a decode rank and then calls
        :meth:`release_handoff`; until then this engine keeps the source
        blocks leased."""
        out, self.ready_handoffs = self.ready_handoffs, []
        return out

    def handoff_state(self, slot: int) -> dict:
        """The decode-state row that migrates with the KV: the next input
        token (the first sampled one), the next position (the prompt's
        end), the temperature and the request's generator object, which
        has drawn the first token and goes on from there."""
        return {"tok": int(self._tok[slot]), "pos": int(self._pos[slot]),
                "temp": float(self._temp[slot]), "gen": self._gen[slot]}

    def release_handoff(self, slot: int) -> None:
        """Migration complete: return the source row and its blocks to
        the pools and park the row."""
        self.kv.free(slot)
        self._pos[slot] = PARK_POS
        self._temp[slot] = 0.0
        self._gen[slot] = None

    def begin_import(self, req: ServeRequest):
        """Decode-rank half of the handoff, part 1: claim a request row
        and lease blocks for the request's whole budget (prompt +
        max_new) before the transport copies: the posted receive.
        Returns ``(slot, dst_blocks)``; the transport writes the prompt's
        KV into the first ``blocks_for(prompt_len)`` of ``dst_blocks``."""
        if self.kv_layout != "paged":
            raise ValueError("KV-block import needs kv_layout='paged'")
        slot = self.kv.alloc(req, req.prompt_len + req.max_new_tokens)
        return slot, self.kv.blocks_of(slot)

    def finish_import(self, slot: int, handoff: KVHandoff, state_row: dict,
                      now: float) -> None:
        """Decode-rank half, part 2 (after the transport's waitall):
        install the migrated decode state at ``slot`` and enter the
        request into this engine's decode rows, where the prefill rank
        stopped (generated == 1, next position == the prompt's end). The
        generator object itself moves: re-deriving it from ``(seed,
        rid)`` would replay the first token's draw."""
        req = handoff.req
        self.kv.advance(slot, handoff.length)    # resident prompt tokens
        self._tok[slot] = state_row["tok"]
        self._pos[slot] = state_row["pos"]
        self._temp[slot] = state_row["temp"]
        self._gen[slot] = state_row["gen"]
        req.state = "decoding"
        self._slot_req[slot] = req
        self._slot_out[slot] = handoff.out

    def reset(self, *, strict: bool = False,
              preserve_prefix: bool = False) -> None:
        """Return the engine to its post-construction state: every row
        freed, decode state parked, scheduler queues and accounting
        cleared. ``preserve_prefix=True`` (prefix cache only) keeps the
        parked radix index and the pool's contents: the warm-cache run.
        Rows still holding requests are lease leaks: named via
        ``LeaseLeakWarning``, or ``LeaseLeakError`` when ``strict``."""
        self._fresh_state()
        self._prefilling.clear()
        self.ready_handoffs.clear()
        if self.prefix_cache is not None and preserve_prefix:
            self.kv.reset_rows(strict=strict)
        else:
            if self.prefix_cache is not None:
                # drop the cache's references first: parked blocks are
                # retention by design, not leaks for the pool to name
                self.prefix_cache.clear()
            self.kv.reset(strict=strict)
        if self.speculate:
            self.draft_kv.reset(strict=strict)
            self._draft_len[:] = 0
        self.scheduler.reset()
        self._zero_accounting()
        if self.prefix_cache is not None:
            self.prefix_cache.reset_stats()
        # telemetry is trial-scoped too, on both reset flavours: residual
        # pairs and registry observations of a warm-up must not aggregate
        # into the measured trial
        _obs_flush_trial()

    # -- batch-API convenience ---------------------------------------------
    def generate(self, batch, max_new_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Same-arrival batch through the continuous path: split the batch
        into per-row requests, run micro-steps until drained, reassemble
        (B, max_new) in row order."""
        B = batch["tokens"].shape[0]
        reqs = []
        for i in range(B):
            row = {k: np.asarray(v[i:i + 1]) for k, v in batch.items()}
            req = ServeRequest(rid=i, batch=row,
                               max_new_tokens=max_new_tokens,
                               temperature=temperature, seed=seed)
            reqs.append(req)
            self.submit(req, 0.0)
        chunk_steps = (sum(-(-r.prompt_len // self.prefill_chunk) + 1
                           for r in reqs) if self.prefill_chunk else B)
        limit = (B * (max_new_tokens + 2)) // max(1, self.kv.num_slots) \
            + B * (max_new_tokens + 2) + chunk_steps
        steps = 0
        while not self.idle:
            self.step(0.0)
            steps += 1
            if steps > limit:
                raise RuntimeError("continuous generate failed to drain")
        return np.stack([r.output for r in reqs])
