"""Buffered IPC Channels (SiPipe §6).

Three channel kinds, mirroring the paper:
  BIC-I  scheduling outputs, scheduler -> workers/samplers (dispatch)
  BIC-L  logits, final stage -> sampler pool (dispatch)
  BIC-O  sampling outputs, samplers -> scheduler (combine, sub-slots)

The shared-memory implementation (``ShmRing``) uses an N-slot ring with a
*lock-ahead* protocol: in iteration n the producer pre-acquires slot
(n+1) %% N, writes slot n %% N, then releases it — consumers poll slots in
order under shared locks, so steady-state progress never contends.  A
lighter ``LocalRing`` (threading) backs the in-process engine; both expose
the same interface so the engine is transport-agnostic.
"""
from __future__ import annotations

import mmap
import os
import pickle
import struct
import tempfile
import threading
import time
from typing import Any, List, Optional

import numpy as np

_HDR = struct.Struct("<QQ")  # (seq, payload_len)


class LocalRing:
    """In-process N-slot ring with per-slot condition variables."""

    def __init__(self, n_slots: int = 8, name: str = ""):
        self.n = n_slots
        self.name = name
        self._slots: List[Optional[Any]] = [None] * n_slots
        self._seq = [-1] * n_slots
        self._cv = threading.Condition()
        self._head = 0  # next sequence number to write

    def put(self, item: Any, timeout: float = 30.0) -> int:
        with self._cv:
            seq = self._head
            slot = seq % self.n
            # lock-ahead analogue: ensure the *next* slot's consumer lag is
            # bounded by N (writer never laps readers by a full ring)
            self._slots[slot] = item
            self._seq[slot] = seq
            self._head += 1
            self._cv.notify_all()
            return seq

    def get(self, seq: int, timeout: float = 30.0) -> Any:
        deadline = time.monotonic() + timeout
        slot = seq % self.n
        with self._cv:
            while self._seq[slot] < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"BIC {self.name}: seq {seq} not produced")
                self._cv.wait(remaining)
            if self._seq[slot] != seq:
                raise RuntimeError(
                    f"BIC {self.name}: slot overwritten (seq {seq} -> {self._seq[slot]}); "
                    f"ring too small for consumer lag")
            return self._slots[slot]


class ShmRing:
    """Cross-process shared-memory ring (file-backed mmap + fcntl locks).

    Slot layout: [lock byte area | header (seq, len) | payload bytes].
    The producer lock-ahead acquires slot n+1 before publishing slot n.
    """

    def __init__(self, slot_bytes: int, n_slots: int = 8, path: str = "",
                 create: bool = True):
        self.n = n_slots
        self.slot_bytes = slot_bytes
        self.stride = _HDR.size + slot_bytes
        self.path = path or tempfile.mktemp(prefix="sipipe_bic_")
        total = self.stride * n_slots
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(self.path, flags, 0o600)
        if create:
            os.ftruncate(self._fd, total)
            # initialize headers to seq = -1
            with mmap.mmap(self._fd, total) as mm:
                for s in range(n_slots):
                    mm[s * self.stride : s * self.stride + _HDR.size] = _HDR.pack(
                        2**64 - 1, 0)
        self._mm = mmap.mmap(self._fd, total)
        self._head = 0

    # -- fcntl slot locks ---------------------------------------------------
    def _lock(self, slot: int, exclusive: bool):
        import fcntl

        fcntl.lockf(self._fd, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH,
                    1, slot, os.SEEK_SET)

    def _unlock(self, slot: int):
        import fcntl

        fcntl.lockf(self._fd, fcntl.LOCK_UN, 1, slot, os.SEEK_SET)

    def put(self, item: Any, seq: Optional[int] = None) -> int:
        if seq is None:
            seq = self._head
        payload = item if isinstance(item, (bytes, bytearray)) else pickle.dumps(
            item, protocol=pickle.HIGHEST_PROTOCOL)
        assert len(payload) <= self.slot_bytes, (len(payload), self.slot_bytes)
        slot = seq % self.n
        nxt = (seq + 1) % self.n
        self._lock(nxt, exclusive=True)      # lock-ahead
        try:
            self._lock(slot, exclusive=True)
            try:
                off = slot * self.stride
                self._mm[off + _HDR.size : off + _HDR.size + len(payload)] = payload
                self._mm[off : off + _HDR.size] = _HDR.pack(seq, len(payload))
            finally:
                self._unlock(slot)
        finally:
            self._unlock(nxt)
        self._head = seq + 1
        return seq

    def get(self, seq: int, timeout: float = 30.0, raw: bool = False) -> Any:
        slot = seq % self.n
        off = slot * self.stride
        deadline = time.monotonic() + timeout
        while True:
            self._lock(slot, exclusive=False)
            try:
                got_seq, ln = _HDR.unpack(self._mm[off : off + _HDR.size])
                if got_seq == seq:
                    data = bytes(self._mm[off + _HDR.size : off + _HDR.size + ln])
                    return data if raw else pickle.loads(data)
                if got_seq != 2**64 - 1 and got_seq > seq:
                    raise RuntimeError(f"slot overwritten: want {seq} have {got_seq}")
            finally:
                self._unlock(slot)
            if time.monotonic() > deadline:
                raise TimeoutError(f"seq {seq} not available")
            time.sleep(0.0002)

    def close(self, unlink: bool = False):
        self._mm.close()
        os.close(self._fd)
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class SubSlotRing:
    """BIC-O: multi-producer combine ring.  Slot n has one sub-slot per
    sampler; the consumer sees iteration n complete when all sub-slots are
    filled (each sub-slot is typically just token ids)."""

    def __init__(self, n_producers: int, n_slots: int = 8):
        self.k = n_producers
        self.n = n_slots
        self._cv = threading.Condition()
        self._data: List[List[Optional[Any]]] = [
            [None] * n_producers for _ in range(n_slots)]
        self._seq = [[-1] * n_producers for _ in range(n_slots)]

    def put(self, seq: int, producer: int, item: Any):
        slot = seq % self.n
        with self._cv:
            self._data[slot][producer] = item
            self._seq[slot][producer] = seq
            self._cv.notify_all()

    def get(self, seq: int, timeout: float = 30.0) -> List[Any]:
        slot = seq % self.n
        deadline = time.monotonic() + timeout
        with self._cv:
            while any(s < seq for s in self._seq[slot]):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"combine seq {seq} incomplete")
                self._cv.wait(remaining)
            if any(s != seq for s in self._seq[slot]):
                raise RuntimeError("combine slot overwritten")
            return list(self._data[slot])
