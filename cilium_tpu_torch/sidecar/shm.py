"""Lock-free SPSC shared-memory rings for the shim ⇄ sidecar seam.

The unix-socket transport copies every flow byte four times (client
pack → kernel send → kernel recv → BufferedReader) before the service
can even look at it.  This module moves the BULK bytes off the socket
(Libra's selective-data-copying shape, PAPERS.md): per client session a
pair of single-producer/single-consumer rings in
``multiprocessing.shared_memory``:

- a **data ring** the shim pushes wire data-batch frames into (slot
  header: commit word, wire op, payload length, commit timestamp;
  payload is the UNCHANGED columnar wire frame — seq, conn ids,
  lengths, packed blob — so the service's existing unpack lifts it
  into device arrays without per-entry work), and
- a **verdict ring** the service writes verdict frames back into, in
  place of the socket hop.

The socket stays attached as the CONTROL channel and the fail-closed
fallback rung: ring attach/detach is negotiated over it, batched
``MSG_SHM_DOORBELL``/``MSG_SHM_CREDIT`` notifications ride it (no
thread ever spin-waits on a slot — lint R2's spin-wait rule guards
exactly that), and any ring fault demotes the session to the socket
path typed, never silently.

Memory model: one producer thread and one consumer thread per ring
(the client serializes pushes under its write lock; the service's
verdict pushes are serialized under the client-handler write lock).
Slot publication is a two-phase commit word — invalidated before the
payload write, set to ``position + 1`` after — so a producer dying
mid-write leaves a slot whose commit word CANNOT match the position
the doorbell claims was written: the consumer surfaces :class:`TornSlot`
instead of parsing garbage.  8-byte aligned stores from CPython are
single ``memcpy`` calls under the GIL; both ends of this seam are
same-host processes (AF_UNIX peers), so no cross-architecture ordering
is assumed beyond that.

Payloads are copied OUT of the slot (one bulk memcpy) before the head
advances: credits free slots immediately, and no numpy view into ring
memory can outlive the slot's reuse.  What the shm path removes is the
two kernel copies, the sendall/recv syscalls per frame, and the
framing-buffer churn — the per-entry Python was already gone (the wire
format is columnar).
"""

from __future__ import annotations

import os
import secrets
import struct
import time
from multiprocessing import shared_memory

RING_MAGIC = 0x53484D52  # "SHMR"

# Ring header (bytes 0..64): magic u32, generation u32, slots u32,
# slot_bytes u32, tail u64 (producer cursor), head u64 (consumer
# cursor).  The cursors are mirrored here for occupancy/status; the
# AUTHORITATIVE cursors travel in the doorbell/credit messages so the
# consumer never polls shared memory waiting for them to move.
_HEADER = struct.Struct("<IIII")
_HEADER_BYTES = 64
_TAIL_OFF = 16
_HEAD_OFF = 24
_CURSOR = struct.Struct("<Q")

# Slot header: commit u64 (position+1 when published, 0 while being
# written), msg_type u32, length u32, t_commit f64 (monotonic stamp at
# publish — same host, same clock as the service's arrival stamps).
_SLOT = struct.Struct("<QIId")
SLOT_HEADER_BYTES = 32  # _SLOT.size padded to an 8-byte-aligned 32


class RingError(Exception):
    """Shared-memory transport fault (typed; never a hang)."""


class TornSlot(RingError):
    """A slot the peer claimed committed fails its commit check — the
    producer died mid-write or the segment is corrupt.  The ring must
    be quarantined and the session demoted to the socket path."""


class GenerationMismatch(RingError):
    """Attach-time validation failure: the segment's embedded
    generation (or magic) does not match the negotiated one — a stale
    segment from a previous session must never serve."""


def _segment_name(kind: str) -> str:
    return f"ctpu-{kind}-{os.getpid()}-{secrets.token_hex(4)}"


def _segment_owner_pid(name: str) -> int:
    """Creator pid embedded in a ctpu segment name (-1 if unparseable).
    The name IS the ownership record: no registry survives a kill -9,
    but the pid in the filename does."""
    parts = name.split("-")
    if len(parts) < 4 or parts[0] != "ctpu":
        return -1
    try:
        return int(parts[-2])
    except ValueError:
        return -1


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def sweep_stale_segments(lease_s: float, shm_dir: str = "/dev/shm") -> int:
    """Startup reclaim of predecessor orphans: unlink every ctpu-*
    segment whose creator process is DEAD and whose file age exceeds
    the lease.  A live service reclaims its own peers' segments via
    lease timers; this sweep covers the window those timers cannot —
    the service itself was kill -9'd, so a crashed shim's (or the dead
    service's clients') segments have no survivor to reclaim them until
    the NEXT service boots.  Returns the number of segments removed.

    Safety: a segment whose creator is alive is never touched (its
    lease timer, if any, belongs to a live service), and the age gate
    keeps a segment created a moment before its owner's pid was
    recycled from being misjudged.  Mapped pages of any straggler stay
    valid after unlink (POSIX); only the name is reclaimed.
    """
    removed = 0
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return 0  # no tmpfs view (non-Linux) — nothing to sweep
    now = time.time()
    for name in names:
        if not name.startswith("ctpu-"):
            continue
        pid = _segment_owner_pid(name)
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(shm_dir, name)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            continue  # raced another sweeper
        if pid != -1 and age <= lease_s:
            continue
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass  # raced another sweeper / permissions — not ours then
    return removed


class ShmRing:
    """One SPSC ring over one shared-memory segment.

    The creator (client) owns the segment lifetime (``unlink``); an
    attacher (service) only maps and validates it.  Neither end blocks:
    a full ring refuses the push (socket fallback), an empty ring is
    simply not drained until the next doorbell/credit.
    """

    def __init__(self, seg: shared_memory.SharedMemory, *, slots: int,
                 slot_bytes: int, generation: int, owner: bool):
        self.seg = seg
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.generation = generation
        self.owner = owner
        self.closed = False

    # -- lifecycle --------------------------------------------------------

    @classmethod
    def create(cls, kind: str, generation: int, slots: int,
               slot_bytes: int) -> "ShmRing":
        size = _HEADER_BYTES + slots * slot_bytes
        seg = shared_memory.SharedMemory(
            name=_segment_name(kind), create=True, size=size
        )
        _HEADER.pack_into(seg.buf, 0, RING_MAGIC, generation, slots,
                          slot_bytes)
        _CURSOR.pack_into(seg.buf, _TAIL_OFF, 0)
        _CURSOR.pack_into(seg.buf, _HEAD_OFF, 0)
        # Commit words start at 0 == "never published" for every slot
        # (SharedMemory zero-fills new segments).
        return cls(seg, slots=slots, slot_bytes=slot_bytes,
                   generation=generation, owner=True)

    @classmethod
    def attach(cls, name: str, generation: int) -> "ShmRing":
        seg = shared_memory.SharedMemory(name=name, create=False)
        try:
            magic, gen, slots, slot_bytes = _HEADER.unpack_from(seg.buf, 0)
            if magic != RING_MAGIC:
                raise GenerationMismatch(
                    f"segment {name}: bad magic {magic:#x}"
                )
            if gen != generation:
                raise GenerationMismatch(
                    f"segment {name}: generation {gen} != negotiated "
                    f"{generation} (stale segment)"
                )
            if slots <= 0 or slot_bytes <= SLOT_HEADER_BYTES or (
                _HEADER_BYTES + slots * slot_bytes > seg.size
            ):
                raise GenerationMismatch(
                    f"segment {name}: implausible geometry "
                    f"{slots}x{slot_bytes} for {seg.size} bytes"
                )
        except RingError:
            seg.close()
            raise
        return cls(seg, slots=slots, slot_bytes=slot_bytes,
                   generation=generation, owner=False)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.seg.close()

    def unlink(self) -> None:
        """Creator-side: release the backing segment.  Attached peers'
        mappings stay valid until they close (POSIX semantics)."""
        if self.owner:
            try:
                self.seg.unlink()
            except FileNotFoundError:
                pass

    def force_unlink(self) -> bool:
        """Survivor-side reclaim: unlink the backing segment REGARDLESS
        of ownership.  Only for the abrupt-peer-death path — the
        creator died without detaching and will never run its own
        unlink, so the /dev/shm file would outlive every mapping.  Safe
        against a creator that is actually alive (half-open socket):
        its mappings stay valid and its own later unlink of this name
        is an absorbed FileNotFoundError.  Returns True only when THIS
        call removed the segment (the caller's reclaim accounting must
        not count no-ops)."""
        try:
            self.seg.unlink()
            return True
        except FileNotFoundError:
            return False  # the creator got there first (orderly teardown)
        except OSError:
            return False  # already reclaimed / platform refuses

    # -- cursors (informational mirrors) ----------------------------------

    @property
    def tail(self) -> int:
        try:
            return _CURSOR.unpack_from(self.seg.buf, _TAIL_OFF)[0]
        except (ValueError, TypeError):  # segment released/closed
            return 0

    @property
    def head(self) -> int:
        try:
            return _CURSOR.unpack_from(self.seg.buf, _HEAD_OFF)[0]
        except (ValueError, TypeError):  # segment released/closed
            return 0

    def occupancy(self) -> int:
        return max(self.tail - self.head, 0)

    # -- producer ---------------------------------------------------------

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.slot_bytes - SLOT_HEADER_BYTES

    def try_push(self, msg_type: int, payload,
                 credited_head: int) -> bool:
        """Publish one frame; False when the ring is full relative to
        the peer's last credited head (caller falls back to the
        socket — NEVER blocks or spins).

        ``payload`` is one buffer OR a list of buffers written
        scatter-gather straight into the slot — the zero-copy path for
        columnar frames whose bulk part (pre-padded rows, packed blob)
        already exists as one contiguous buffer: no intermediate
        ``b"".join`` materialization."""
        if self.closed:
            return False
        parts = (
            payload if isinstance(payload, (list, tuple)) else (payload,)
        )
        total = sum(len(p) for p in parts)
        try:
            pos = self.tail
            if pos - credited_head >= self.slots:
                return False
            if not self.fits(total):
                return False
            off = _HEADER_BYTES + (pos % self.slots) * self.slot_bytes
            buf = self.seg.buf
            # Two-phase publish: invalidate, write, then commit pos+1.
            _CURSOR.pack_into(buf, off, 0)
            cur = off + SLOT_HEADER_BYTES
            for p in parts:
                buf[cur : cur + len(p)] = p
                cur += len(p)
            _SLOT.pack_into(buf, off, pos + 1, msg_type, total,
                            time.monotonic())
            _CURSOR.pack_into(buf, _TAIL_OFF, pos + 1)
        except (ValueError, TypeError):
            # The segment was released by a concurrent disconnect
            # teardown: refuse the push — the caller's socket fallback
            # (or its typed SidecarUnavailable) owns the outcome.
            return False
        return True

    # -- consumer ---------------------------------------------------------

    def read(self, pos: int) -> tuple[int, bytes, float]:
        """Copy slot ``pos`` out: (msg_type, payload, t_commit).
        Raises :class:`TornSlot` when the commit word or geometry does
        not match — only ever called for positions the peer's doorbell
        claimed were fully published."""
        off = _HEADER_BYTES + (pos % self.slots) * self.slot_bytes
        commit, msg_type, length, t_commit = _SLOT.unpack_from(
            self.seg.buf, off
        )
        if commit != pos + 1:
            raise TornSlot(
                f"slot {pos % self.slots}: commit {commit} != "
                f"expected {pos + 1} (producer died mid-write or "
                f"stale segment)"
            )
        if length > self.slot_bytes - SLOT_HEADER_BYTES:
            raise TornSlot(
                f"slot {pos % self.slots}: length {length} exceeds "
                f"slot capacity"
            )
        body = off + SLOT_HEADER_BYTES
        # One bulk copy out of the ring: the head may then advance (and
        # the slot be reused) without any live view into ring memory.
        return msg_type, bytes(self.seg.buf[body : body + length]), t_commit

    def set_head(self, pos: int) -> None:
        _CURSOR.pack_into(self.seg.buf, _HEAD_OFF, pos)

    def status(self) -> dict:
        return {
            "name": self.seg.name,
            "slots": self.slots,
            "slot_bytes": self.slot_bytes,
            "head": self.head,
            "tail": self.tail,
            "occupancy": self.occupancy(),
        }
