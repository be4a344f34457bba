"""Micro-batching serving engine: the counterpart of
``sdtpu/pipeline/serving.py``.

:class:`ServingEngine` runs a background worker thread: requests that share
a bucket (image size, steps, sampler, CFG and its scale, img2img with its
strength and mask flag, CLIP skip, the weighting mode, window count, CFG
rescale, PAG, FreeU, the ControlNet scale(s), the encoder cache) are
coalesced up to
``max_batch_size`` or until one global ``max_wait_ms`` window passes, run
as ``generate_batch`` requests of at most ``device_batch_size`` rows, and
resolved to per-request futures.  Per-request keys and per-row negative
prompts make each row's math independent of its batch; on a card the
kernels' split-K plans depend on the batch (``plan_conv3x3_split``), so a
row may differ from its solo image by rounding, which
``tools/check_batch_invariance.py`` bounds (at most one uint8 level on at
most 3% of values).

The worker keeps two batches in flight: it dispatches batch N+1
(``output="device"``) before it fetches batch N.  A transient error
retries a batch once; a ValueError or TypeError fails its futures at once.

Each request gets an id at ``submit`` and a submit stamp on the span
recorder's clock (``utils/profiling.clock_ns``), which its latency in
``stats()`` reads too.  While spans are recorded (``utils/profiling.py``)
the engine records ``engine.queued`` per request (submit to the start of
its chunk's dispatch), and per batch ``engine.collect`` (the worker's
first request to the batch's close: ``rows``, ``pending``), and per device
chunk ``engine.dispatch`` (``batch`` id, request ids; the pipeline's spans
inside it are its children), ``engine.fetch`` (the images' copy to the
host) and ``engine.retry`` (a synchronous retry).

With a ``mesh`` every device batch runs as ``generate_batch(mesh=)``, its
rows split over dp; a chunk that does not divide by dp (a lone request, a
tail) is padded to a multiple of dp with copies of its last request, whose
extra images are dropped.  The JAX engine lives in one controller process; the
port's ranks are separate processes (``parallel/mesh.py``), whose own
timers, retries and pipelining would make different batches.  So on a mesh
of several ranks every rank builds the engine, rank 0 alone takes requests
and decides each device batch (its retries and failures too), and
broadcasts each ``generate_batch`` call to the other ranks, which replay it
in a follower loop until rank 0's ``shutdown``.  A rank that fails alone
inside a collective (a lost card) leaves the others waiting in it.  A mesh
of one rank serves as no mesh does.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch.distributed as dist

from sdtpu_torch.parallel.mesh import Mesh
from sdtpu_torch.utils import profiling
from sdtpu_torch.utils.profiling import stage

_FAILED = object()  # dispatch sentinel: the batch is already resolved with an error

# Rows per device request (ServingEngine.device_batch_size); the bench's
# warmup reads it.
DEFAULT_DEVICE_BATCH = 4


@dataclasses.dataclass
class _Request:
    prompt: str
    negative_prompt: str
    seed: int
    token_ids: Optional[np.ndarray]
    future: Future
    image_size: int
    steps: int
    sampler: str
    cfg: bool
    cfg_scale: float
    init_image: Optional[np.ndarray] = None
    mask_image: Optional[np.ndarray] = None
    strength: float = 0.9
    image_guidance_scale: float = 1.5
    # the step features pick the request's program; the control map is per
    # row, its scale (one, or one per net) the batch's
    guidance_rescale: float = 0.0
    pag_scale: float = 0.0
    freeu: Optional[tuple] = None
    control_image: Optional[np.ndarray] = None
    controlnet_scale: float = 1.0
    encoder_cache_interval: int = 1
    clip_skip: int = 0
    # prompt emphasis: the (word:1.3) syntax parsed per row, or per-token
    # weights aligned with token_ids
    prompt_weighting: bool = False
    token_weights: Optional[np.ndarray] = None
    # rows with different CLIP window counts do not coalesce: padded empty
    # windows would make a row's context depend on its batch
    n_windows: int = 1
    id: int = 0  # the engine's request id (the spans' ``requests``)
    t_submit: int = 0  # enqueue time, profiling.clock_ns (latencies, engine.queued)
    submit_tid: int = 0  # the submitting thread (engine.queued's row)

    @property
    def bucket(self):
        # the negative prompt and the image, mask and control contents are
        # per row; the mask flag, strength, image guidance, the step
        # features and the control scale(s) pick the request's program
        img2img = self.init_image is not None
        # weighted rows feed generate_batch differently: three modes
        weighting = ("pw" if self.prompt_weighting
                     else "tw" if self.token_weights is not None else None)
        scales = (self.controlnet_scale if isinstance(self.controlnet_scale, (list, tuple))
                  else [self.controlnet_scale])
        return (self.image_size, self.steps, self.sampler, self.cfg,
                round(self.cfg_scale, 6), img2img, self.mask_image is not None,
                round(self.strength, 6) if img2img else None,
                round(self.image_guidance_scale, 6) if img2img else None,
                round(self.guidance_rescale, 6), round(self.pag_scale, 6),
                None if self.freeu is None else tuple(round(float(v), 6) for v in self.freeu),
                self.clip_skip, weighting,
                (tuple(round(float(v), 6) for v in scales)
                 if self.control_image is not None else None),
                self.n_windows, self.encoder_cache_interval)


class ServingEngine:
    """Threaded micro-batcher over a :class:`StableDiffusionPipeline`."""

    def __init__(self, pipeline, *, max_batch_size: int = 8, max_wait_ms: float = 20.0,
                 max_retries: int = 1, device_batch_size: Optional[int] = DEFAULT_DEVICE_BATCH,
                 mesh=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a sdtpu_torch.parallel mesh (make_mesh, "
                            f"global_mesh), not {type(mesh).__name__}")
        if device_batch_size is not None and device_batch_size < 1:
            raise ValueError("device_batch_size must be >= 1")
        if mesh is not None and device_batch_size is not None and device_batch_size % mesh.dp:
            raise ValueError(f"device_batch_size {device_batch_size} must be a multiple of "
                             f"dp={mesh.dp}")
        self.mesh = mesh
        # several ranks: rank 0 leads, the others replay its calls
        self._spmd = mesh is not None and mesh.size > 1
        self._follower = self._spmd and mesh.rank != 0
        self.pipeline = pipeline
        self.max_batch_size = max_batch_size
        # rows per device request: a collected batch larger than this runs
        # as several pipelined requests (None: one per collected batch)
        self.device_batch_size = device_batch_size
        self.max_wait_ms = max_wait_ms
        self.max_retries = max_retries
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._shutdown = threading.Event()
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "failures": 0, "retries": 0}
        self._batch_ids = itertools.count(1)
        # rolling submit -> resolve latencies (p50/p95 in stats())
        self._latencies: "collections.deque[float]" = collections.deque(maxlen=1024)
        self._worker = threading.Thread(target=self._follow if self._follower else self._run,
                                        daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Requests served, batches run, failures, retries, mean batch size,
        and the p50/p95 request latency (submit to resolve)."""
        with self._lock:
            s = dict(self._stats)
            lat = sorted(self._latencies)
        s["mean_batch_size"] = s["requests"] / s["batches"] if s["batches"] else 0.0
        if lat:
            s["request_latency_p50_s"] = lat[len(lat) // 2]
            s["request_latency_p95_s"] = lat[min(len(lat) - 1, int(len(lat) * 0.95))]
        return s

    # -- client API -----------------------------------------------------------

    def submit(self, prompt: str, *, negative_prompt: str = "", seed: int = 0,
               token_ids: Optional[np.ndarray] = None, image_size: Optional[int] = None,
               num_inference_steps: Optional[int] = None, sampler: Optional[str] = None,
               cfg: Optional[bool] = None, cfg_scale: Optional[float] = None,
               init_image: Optional[np.ndarray] = None,
               mask_image: Optional[np.ndarray] = None, strength: float = 0.9,
               clip_skip: int = 0, prompt_weighting: bool = False,
               token_weights: Optional[np.ndarray] = None,
               control_image: Optional[np.ndarray] = None, controlnet_scale: float = 1.0,
               image_guidance_scale: float = 1.5, guidance_rescale: float = 0.0,
               pag_scale: float = 0.0, freeu: Optional[tuple] = None,
               encoder_cache_interval: int = 1) -> Future:
        """Enqueue one txt2img request (img2img with ``init_image``,
        inpainting with ``mask_image`` too; a control map after the
        pipeline's ``load_controlnet``; emphasis with ``prompt_weighting``,
        or ``token_weights`` beside ``token_ids``); the future resolves to an
        (H, W, 3) uint8 image.  Unset knobs resolve to the preset's defaults
        here, so that the bucket is well defined."""
        if self._follower:
            raise RuntimeError(f"rank {self.mesh.rank} follows rank 0's batches: submit "
                               "requests to rank 0")
        if self._shutdown.is_set():
            raise RuntimeError("engine is shut down")
        if mask_image is not None and init_image is None:
            raise ValueError("mask_image requires init_image (inpainting)")
        if control_image is not None and getattr(self.pipeline, "controlnet", None) is None:
            raise ValueError("control_image requires a ControlNet — call "
                             "pipeline.load_controlnet(...) first")
        config = self.pipeline.config
        tok = getattr(self.pipeline, "tokenizer", None)
        w = config.text_config.max_length
        use_cfg = config.default_cfg if cfg is None else cfg
        if token_ids is not None:
            n_windows = max(1, np.asarray(token_ids).shape[-1] // w)
        elif tok is None:
            n_windows = 1
        elif prompt_weighting:
            texts = [prompt] + ([negative_prompt] if use_cfg else [])
            n_windows = max(len(tok.encode_weighted_long(t, window=w)[0]) // w
                            for t in texts)
        else:
            texts = [prompt] + ([negative_prompt] if use_cfg else [])
            n_windows = max(tok.num_windows(t, window=w) for t in texts)
        req = _Request(
            prompt=prompt, negative_prompt=negative_prompt, seed=seed, token_ids=token_ids,
            future=Future(), image_size=image_size or config.default_image_size,
            steps=config.default_steps if num_inference_steps is None else num_inference_steps,
            sampler=sampler or config.default_sampler, cfg=use_cfg,
            cfg_scale=config.default_cfg_scale if cfg_scale is None else cfg_scale,
            init_image=init_image, mask_image=mask_image, strength=strength,
            image_guidance_scale=image_guidance_scale, guidance_rescale=guidance_rescale,
            pag_scale=pag_scale, freeu=freeu, control_image=control_image,
            controlnet_scale=controlnet_scale, encoder_cache_interval=encoder_cache_interval,
            clip_skip=clip_skip, prompt_weighting=prompt_weighting,
            token_weights=token_weights, n_windows=n_windows, id=profiling.new_request_id(),
            t_submit=profiling.clock_ns(), submit_tid=profiling.thread_id())
        self._queue.put(req)
        return req.future

    def generate(self, prompt: str, **kw) -> np.ndarray:
        return self.submit(prompt, **kw).result()

    def shutdown(self, wait: bool = True) -> None:
        """Serve what is queued, then stop; rank 0's also ends the followers
        (a follower's waits for it)."""
        self._shutdown.set()
        if wait:
            self._worker.join(timeout=60)

    # -- worker ---------------------------------------------------------------

    def _collect_batch(self, initial_timeout: float = 0.1) -> List[_Request]:
        # _pending holds requests dequeued but not served yet (another
        # bucket than an earlier batch's): they keep their arrival order and
        # come before new queue items
        if self._pending:
            first = self._pending.popleft()
        else:
            try:
                if initial_timeout <= 0:
                    first = self._queue.get_nowait()
                else:
                    first = self._queue.get(timeout=initial_timeout)
            except queue.Empty:
                return []
        t_first = profiling.clock_ns()
        batch = [first]
        remaining = collections.deque()
        for req in self._pending:
            if len(batch) < self.max_batch_size and req.bucket == first.bucket:
                batch.append(req)
            else:
                remaining.append(req)
        self._pending = remaining
        # one deadline for the whole window, not re-armed per request
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req.bucket == first.bucket:
                batch.append(req)
            else:
                self._pending.append(req)
        profiling.record_span("engine.collect", t_first, profiling.clock_ns(), rows=len(batch),
                              pending=len(self._pending))
        return batch

    def _gen_kwargs(self, batch: List[_Request]) -> tuple:
        """``generate_batch``'s arguments for ``batch``.  On a mesh, a chunk
        whose size does not divide by dp is padded with copies of its last
        request (per-request keys keep the other rows as they are); the
        padded rows' images are never read."""
        if self.mesh is not None:
            batch = batch + batch[-1:] * (-len(batch) % self.mesh.dp)
        first = batch[0]
        token_ids = (None if any(r.token_ids is None for r in batch)
                     else np.stack([np.asarray(r.token_ids) for r in batch]))
        kw = dict(negative_prompt=[r.negative_prompt for r in batch], cfg=first.cfg,
                  cfg_scale=first.cfg_scale, num_inference_steps=first.steps,
                  seeds=[r.seed for r in batch], image_size=first.image_size,
                  token_ids=token_ids, sampler=first.sampler, clip_skip=first.clip_skip,
                  guidance_rescale=first.guidance_rescale, pag_scale=first.pag_scale,
                  freeu=first.freeu, encoder_cache_interval=first.encoder_cache_interval)
        if first.prompt_weighting:
            kw["prompt_weighting"] = True
        elif first.token_weights is not None:
            # one bucket: every row carries weights (and token_ids)
            kw["token_weights"] = np.stack([np.asarray(r.token_weights, np.float32)
                                            for r in batch])
        if first.init_image is not None:
            kw["init_images"] = [r.init_image for r in batch]
            kw["strength"] = first.strength
            kw["image_guidance_scale"] = first.image_guidance_scale
            if first.mask_image is not None:
                kw["mask_images"] = [r.mask_image for r in batch]
        if first.control_image is not None:
            kw["control_images"] = [r.control_image for r in batch]
            kw["controlnet_scale"] = first.controlnet_scale
        return [r.prompt for r in batch], kw

    def _dispatch(self, batch: List[_Request], bid: int):
        """Queue a batch without waiting for it (``output="device"``): the
        device tensor in flight; None defers to a synchronous retry at
        resolve time (a transient error); ``_FAILED`` when a ValueError or
        TypeError has failed the batch's futures."""
        try:
            with stage("engine.dispatch", requests=[r.id for r in batch], batch=bid) as t0:
                if t0 is not None:  # recorded: each request waited until now
                    for r in batch:
                        profiling.record_span("engine.queued", r.t_submit, t0,
                                              requests=(r.id,), tid=r.submit_tid)
                prompts, kw = self._gen_kwargs(batch)
                return self._generate(prompts, output="device", **kw)
        except (ValueError, TypeError) as exc:  # deterministic: no retry
            with self._lock:
                self._stats["failures"] += len(batch)
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
            return _FAILED
        except Exception:
            with self._lock:
                self._stats["retries"] += 1
            return None

    def _generate(self, prompts, **kw):
        """``generate_batch`` on the mesh; rank 0 of several first sends
        the call to the followers."""
        if self.mesh is None:
            return self.pipeline.generate_batch(prompts, **kw)
        if self._spmd:
            dist.broadcast_object_list([(prompts, kw)], src=0)
        return self.pipeline.generate_batch(prompts, mesh=self.mesh, **kw)

    def _follow(self) -> None:
        """A follower rank: replay rank 0's calls until its shutdown (None).
        A call that fails here fails on rank 0 too, which resolves its
        futures; the follower logs it and goes on."""
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0)
            if msg[0] is None:
                return
            prompts, kw = msg[0]
            try:
                self.pipeline.generate_batch(prompts, mesh=self.mesh, **kw)
            except Exception:  # the loop must keep following
                logging.getLogger("sdtpu_torch.serving").exception(
                    "rank %d: a replayed batch failed", self.mesh.rank)

    def _record(self, batch: List[_Request], images) -> None:
        now = profiling.clock_ns()
        for i, req in enumerate(batch):
            if not req.future.done():  # the client may have cancelled
                req.future.set_result(images[i])
        with self._lock:
            self._latencies.extend((now - r.t_submit) / 1e9 for r in batch)
            self._stats["requests"] += len(batch)
            self._stats["batches"] += 1

    def _resolve(self, batch: List[_Request], dev, bid: int) -> None:
        if dev is not None:
            try:
                with stage("engine.fetch", requests=[r.id for r in batch], batch=bid):
                    images = dev.cpu().numpy()
            except Exception:
                with self._lock:
                    self._stats["retries"] += 1
            else:
                self._record(batch, images)
                return
        self._execute_sync(batch, bid)

    def _execute_sync(self, batch: List[_Request], bid: int) -> None:
        """Run a batch and wait for it: a transient error retries it up to
        ``max_retries`` times, a ValueError or TypeError fails it at once."""
        prompts, kw = self._gen_kwargs(batch)
        for attempt in range(self.max_retries + 1):
            try:
                with stage("engine.retry", requests=[r.id for r in batch], batch=bid,
                           attempt=attempt):
                    images = self._generate(prompts, **kw)
            except Exception as exc:  # resolve the futures; the worker lives on
                if not isinstance(exc, (ValueError, TypeError)) and attempt < self.max_retries:
                    with self._lock:
                        self._stats["retries"] += 1
                    continue
                with self._lock:
                    self._stats["failures"] += len(batch)
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
                return
            self._record(batch, images)
            return

    def _run(self) -> None:
        # Up to two device requests in flight: while one computes, the
        # worker collects and dispatches the next, then fetches the oldest.
        # A collected batch larger than device_batch_size runs as several
        # requests in arrival order (per-request keys make the rows
        # independent of the chunking).
        inflight = collections.deque()  # (chunk, device images or None, batch id)
        while True:
            drained = self._shutdown.is_set() and self._queue.empty() and not self._pending
            if drained and not inflight:
                break
            batch = [] if drained else self._collect_batch(
                initial_timeout=0.0 if inflight else 0.1)
            if not batch:
                if inflight:
                    self._resolve(*inflight.popleft())
                continue
            db = self.device_batch_size or self.max_batch_size
            for i in range(0, len(batch), db):
                chunk, bid = batch[i:i + db], next(self._batch_ids)
                dev = self._dispatch(chunk, bid)
                if dev is not _FAILED:
                    inflight.append((chunk, dev, bid))
                while len(inflight) > 2:
                    self._resolve(*inflight.popleft())
            while len(inflight) > 1:
                self._resolve(*inflight.popleft())
        if self._spmd:
            dist.broadcast_object_list([None], src=0)  # end the followers
