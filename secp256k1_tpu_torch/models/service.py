"""Aggregating ECDSA verify service: requests gathered into device batches,
each resolved through a future.

The port of `secp256k1_tpu.models.service`.  Callers `submit` one (key,
digest, signature) at a time from any thread; one worker thread drains the
intake queue into batches of up to `max_lanes` and verifies each batch on
the device, one batch at a time, each waiting for its statuses before the
next is marshalled (as the JAX service does: its verify calls return host
statuses).  The overlap is between the callers' `submit` threads and the
worker.

Every verify call, and the keyed path's `PubkeyCache`, runs on the
service's device: `device=None` means the GPU, and the service raises at
construction when there is none; `device="cpu"` runs the plain path.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from ..utils import batching as bt
from ..utils import config as cfg
from . import ecdsa as ecdsamod


@dataclass
class _Pending:
    pub: object
    digest: bytes
    sig: bytes
    future: Future = field(default_factory=Future)


class _KeyCache:
    """Fixed-capacity device-resident signer table for the keyed fast path.

    Distinct signers seen by the service accumulate into one `PubkeyCache`
    (padded to `capacity` with the first key); a batch then names its keys
    by index.  `lookup` returns None once the signers would overflow the
    capacity, and the caller takes the unkeyed path.  The port's
    `PubkeyCache` rejects a key that is not a point of the curve."""

    def __init__(self, capacity: int, device):
        self.capacity = capacity
        self.device = device
        self.index: dict = {}
        self.points: list = []
        self.cache = None

    def lookup(self, pubs):
        uniq_new = []
        seen = set()
        for p in pubs:
            if p not in self.index and p not in seen:
                seen.add(p)
                uniq_new.append(p)
        if len(self.points) + len(uniq_new) > self.capacity:
            return None
        if uniq_new or self.cache is None:
            for p in uniq_new:
                self.index[p] = len(self.points)
                self.points.append(p.point)
            if not self.points:
                return None
            pad = [self.points[0]] * (self.capacity - len(self.points))
            self.cache = ecdsamod.PubkeyCache(self.points + pad, self.device)
        return np.asarray([self.index[p] for p in pubs], np.int32)


class VerifyService:
    """Aggregating ECDSA verify service.

    submit() enqueues one (pub, digest, sig); the worker thread drains the
    queue into batches of up to max_lanes, verifies each on the device and
    resolves each future with a bool.  flush() waits for everything queued
    before it; close() flushes and ends the worker."""

    def __init__(self, opts: cfg.ECDSAOptions | None = None,
                 max_lanes: int = 16384, max_wait_s: float = 0.005,
                 max_pending: int = 0, key_cache_capacity: int = 0,
                 device=None):
        """max_pending > 0 bounds the intake queue: submit() blocks once
        that many requests are waiting (backpressure).

        key_cache_capacity > 0 enables the keyed fast path: up to that many
        distinct signers live on the device (`ecdsa.PubkeyCache`) and a
        batch names its keys by index."""
        self.device = bt.resolve_device(device)
        self.opts = opts or cfg.ECDSAOptions()
        self.max_lanes = max_lanes
        self.max_wait_s = max_wait_s
        self._keys = (_KeyCache(key_cache_capacity, self.device)
                      if key_cache_capacity > 0 else None)
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._closed = False
        self.batches = 0
        self.verified = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, pub, digest: bytes, sig: bytes,
               timeout: float | None = None) -> Future:
        """Enqueue one verification; blocks (up to timeout) while the
        intake queue is full.  Raises queue.Full on timeout."""
        if self._closed:
            raise RuntimeError("service closed")
        p = _Pending(pub, digest, sig)
        self._q.put(p, timeout=timeout)
        return p.future

    def flush(self) -> None:
        """Block until everything queued before this call has resolved."""
        if not self._worker.is_alive():         # closed: nothing is queued
            return
        done = Future()
        self._q.put(done)
        done.result()

    def close(self) -> None:
        """Flush, then end the worker thread."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        self._q.put(None)
        self._worker.join()

    # ------------------------------------------------------------------

    def _run(self) -> None:
        stop = False
        while not stop:
            item = self._q.get()
            batch: list[_Pending] = []
            barriers: list[Future] = []
            deadline = time.monotonic() + self.max_wait_s
            while True:
                if item is None:                # close(): the last batch
                    stop = True
                    break
                if isinstance(item, Future):
                    barriers.append(item)
                    break
                batch.append(item)
                if len(batch) >= self.max_lanes:
                    break
                try:
                    item = self._q.get(
                        timeout=max(deadline - time.monotonic(), 0))
                except queue.Empty:
                    break
            if batch:
                self._process(batch)
            for b in barriers:
                b.set_result(True)

    def _fast_path_ok(self, batch: list[_Pending]) -> bool:
        """The arrays pipeline takes the common serving shape: ASN.1
        signatures and 32-byte digests (one native DER parse, marshalling
        in numpy).  Everything else takes the list path."""
        return (self.opts.encoding == cfg.SignatureEncoding.ASN1
                and cfg.HASH_SIZES.get(self.opts.hash) == 32
                and all(len(p.digest) == 32 for p in batch)
                and all(hasattr(p.pub, "compressed_bytes") for p in batch))

    def _verify(self, batch: list[_Pending]) -> list:
        if not self._fast_path_ok(batch):
            return ecdsamod.verify_batch(
                [p.pub for p in batch], [p.digest for p in batch],
                [p.sig for p in batch], opts=self.opts, device=self.device)
        n = len(batch)
        max_len = max(len(p.sig) for p in batch) or 1
        sig_arr = np.zeros((n, max_len), np.uint8)
        len_arr = np.zeros((n,), np.int32)
        dig_arr = np.zeros((n, 32), np.uint8)
        for i, p in enumerate(batch):
            sig_arr[i, :len(p.sig)] = np.frombuffer(p.sig, np.uint8)
            len_arr[i] = len(p.sig)
            dig_arr[i] = np.frombuffer(p.digest, np.uint8)
        idx = (self._keys.lookup([p.pub for p in batch])
               if self._keys is not None
               and all(hasattr(p.pub, "point") for p in batch) else None)
        if idx is not None:
            st = ecdsamod.verify_batch_arrays_keyed(
                self._keys.cache, idx, dig_arr, sig_arr, len_arr,
                reject_malleable=self.opts.reject_malleable)
        else:
            pub_arr = np.stack([np.frombuffer(p.pub.compressed_bytes(),
                                              np.uint8) for p in batch])
            st = ecdsamod.verify_batch_arrays(
                pub_arr, dig_arr, sig_arr, len_arr,
                reject_malleable=self.opts.reject_malleable,
                device=self.device)
        return [s == 0 for s in st]

    def _process(self, batch: list[_Pending]) -> None:
        try:
            oks = self._verify(batch)
        except Exception as e:  # every future of the batch gets the error
            for p in batch:
                p.future.set_exception(e)
            return
        self.batches += 1
        self.verified += len(batch)
        for p, ok in zip(batch, oks):
            p.future.set_result(bool(ok))
