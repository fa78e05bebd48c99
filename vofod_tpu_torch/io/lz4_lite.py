"""Pure-Python LZ4 frame codec (no external ``lz4`` package needed).

A copy of vofod_tpu/io/lz4_lite.py for the PyTorch port (importing
vofod_tpu loads JAX); tests/test_torch_shared_copies.py holds it to the
original.

Why this exists: ROS bags recorded with ``rosbag record --lz4`` store each
chunk as an LZ4 frame (roslz4's lz4s.c implements the LZ4 streaming-format
spec — magic 0x184D2204, frame descriptor, size-prefixed blocks, EndMark).
The baked environment has neither ``lz4`` nor ``roslz4``, so without this
module such bags would require an external ``rosbag decompress`` pass before
`io/rosbag_lite` could read them.  See rosbag_lite.read_bag for the
integration (the real ``lz4`` package still takes priority when importable).

Scope:

* ``decompress`` — full LZ4 frame reader: multiple concatenated frames,
  skippable frames, stored (uncompressed) blocks, block-DEPENDENT frames
  (matches may reach into the previous blocks' output — roslz4 writes
  dependent blocks), optional content-size/dict-id fields.  Block and
  content xxh32 checksums are verified when present.
* ``compress`` — valid single-frame writer (block-independent, 4 MiB
  blocks, header checksum, no content checksum) over a greedy hash-table
  block compressor; incompressible blocks are stored raw, exactly like the
  reference encoder.
* ``xxh32`` — needed for the frame header checksum byte; exposed for tests.

Throughput is pure-Python (~tens of MB/s decode) — fine for ingest tooling,
not a hot path: scans are decoded once into NPZ (tools/bag_to_npz.py).
"""

from __future__ import annotations

import struct

MAGIC = 0x184D2204
_SKIP_MAGIC_MIN = 0x184D2A50
_SKIP_MAGIC_MAX = 0x184D2A5F

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the checksum LZ4 frames use)."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        lim = n - 16
        while i <= lim:
            (a, b, c, d) = struct.unpack_from("<4I", data, i)
            v1 = (v1 + a * _P2) & _M32
            v1 = (((v1 << 13) | (v1 >> 19)) * _P1) & _M32
            v2 = (v2 + b * _P2) & _M32
            v2 = (((v2 << 13) | (v2 >> 19)) * _P1) & _M32
            v3 = (v3 + c * _P2) & _M32
            v3 = (((v3 << 13) | (v3 >> 19)) * _P1) & _M32
            v4 = (v4 + d * _P2) & _M32
            v4 = (((v4 << 13) | (v4 >> 19)) * _P1) & _M32
            i += 16
        h = (
            ((v1 << 1) | (v1 >> 31))
            + ((v2 << 7) | (v2 >> 25))
            + ((v3 << 12) | (v3 >> 20))
            + ((v4 << 18) | (v4 >> 14))
        ) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (h + struct.unpack_from("<I", data, i)[0] * _P3) & _M32
        h = (((h << 17) | (h >> 15)) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M32
        h = (((h << 11) | (h >> 21)) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# Block layer
# ---------------------------------------------------------------------------


def decompress_block(
    src: bytes, out: bytearray, window_start: int = 0
) -> None:
    """Decode one LZ4 block, APPENDING to ``out``.

    ``out`` may already hold earlier output: matches whose offset reaches
    before the block's own start then copy from that history, which is how
    block-dependent frames chain (roslz4 writes dependent blocks).
    ``window_start`` is the earliest ``out`` position matches may legally
    reach (the block's own start for block-INDEPENDENT frames, the frame's
    start for dependent ones) — corrupt offsets reaching further raise
    instead of silently copying unrelated history.

    Every length/offset field is bounds-checked before use, so truncated or
    corrupt blocks raise ValueError — never IndexError, never an overread.
    """
    n = len(src)
    i = 0
    while i < n:
        token = src[i]
        i += 1
        # literals
        ll = token >> 4
        if ll == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4 block: truncated literal length")
                x = src[i]
                i += 1
                ll += x
                if x != 255:
                    break
        if ll:
            if i + ll > n:
                raise ValueError("lz4 block: literal run past end")
            out += src[i : i + ll]
            i += ll
        if i >= n:
            break  # last sequence is literals-only
        # match
        if i + 2 > n:
            raise ValueError("lz4 block: truncated match offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0:
            raise ValueError("lz4 block: zero match offset")
        ml = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4 block: truncated match length")
                x = src[i]
                i += 1
                ml += x
                if x != 255:
                    break
        start = len(out) - off
        if start < window_start:
            raise ValueError(
                "lz4 block: match offset reaches before the window "
                f"(offset {off}, window has {len(out) - window_start} bytes)"
            )
        if off >= ml:
            out += out[start : start + ml]
        else:
            # overlapping match: the copy source grows as we write —
            # replicate by doubling the already-copied span
            chunk = bytes(out[start:])
            while len(chunk) < ml:
                chunk = chunk + chunk
            out += chunk[:ml]


def compress_block(src: bytes) -> bytes:
    """Greedy single-pass LZ4 block encoder (hash-table match finder).

    Honors the spec's end conditions: the last 5 bytes are literals and no
    match starts within the final 12 bytes; inputs shorter than 13 bytes are
    emitted as one literal run."""
    n = len(src)
    out = bytearray()

    def emit(lit_start: int, lit_end: int, off: int = 0, ml: int = 0):
        ll = lit_end - lit_start
        token_l = 15 if ll >= 15 else ll
        token_m = 0 if ml == 0 else (15 if ml - 4 >= 15 else ml - 4)
        out.append((token_l << 4) | token_m)
        if ll >= 15:
            r = ll - 15
            while r >= 255:
                out.append(255)
                r -= 255
            out.append(r)
        out.extend(src[lit_start:lit_end])
        if ml:
            out.extend(struct.pack("<H", off))
            if ml - 4 >= 15:
                r = ml - 4 - 15
                while r >= 255:
                    out.append(255)
                    r -= 255
                out.append(r)

    if n < 13:
        emit(0, n)
        return bytes(out)

    table: dict[bytes, int] = {}
    match_limit = n - 12  # no match may start past here
    end_literals = n - 5
    i = 0
    anchor = 0
    while i < match_limit:
        key = src[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            # extend the match forward, but never into the last 5 bytes
            ml = 4
            limit = end_literals - i
            while ml < limit and src[cand + ml] == src[i + ml]:
                ml += 1
            emit(anchor, i, i - cand, ml)
            i += ml
            anchor = i
        else:
            i += 1
    emit(anchor, n)  # trailing literals
    return bytes(out)


# ---------------------------------------------------------------------------
# Frame layer
# ---------------------------------------------------------------------------

_BLOCK_SIZE = 4 << 20  # BD id 7 (4 MiB) — what roslz4 uses


def compress(data: bytes) -> bytes:
    """One LZ4 frame: block-independent 4 MiB blocks, header checksum."""
    flg = 0x60  # version 01, block independence, no checksums/size/dict
    bd = 0x70  # block max size id 7 = 4 MiB
    desc = bytes([flg, bd])
    out = bytearray(struct.pack("<I", MAGIC))
    out += desc
    out.append((xxh32(desc) >> 8) & 0xFF)
    # empty input ⇒ header + EndMark only: the spec reserves Block_Size 0 for
    # the EndMark, so a zero-length data block would be an invalid frame
    for i in range(0, len(data), _BLOCK_SIZE):
        raw = data[i : i + _BLOCK_SIZE]
        comp = compress_block(raw)
        if len(comp) < len(raw):
            out += struct.pack("<I", len(comp))
            out += comp
        else:  # incompressible: stored block (high bit set)
            out += struct.pack("<I", len(raw) | 0x80000000)
            out += raw
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


def decompress(buf: bytes) -> bytes:
    """Decode one or more concatenated LZ4 frames (skippable frames ignored).

    Hardened against corrupt/truncated input: every multi-byte field is
    length-checked before decoding (clean ValueError, never struct.error /
    IndexError), a declared content size that disagrees with the decoded
    length raises, and matches in block-INDEPENDENT frames may not reach
    into earlier blocks' output (see decompress_block window_start)."""
    out = bytearray()
    i = 0
    n = len(buf)

    def u32(at, what):
        if at + 4 > n:
            raise ValueError(f"lz4 frame: truncated {what}")
        return struct.unpack_from("<I", buf, at)[0]

    while i < n:
        magic = u32(i, "magic")
        i += 4
        if _SKIP_MAGIC_MIN <= magic <= _SKIP_MAGIC_MAX:
            size = u32(i, "skippable-frame size")
            i += 4 + size
            if i > n:
                raise ValueError("lz4 frame: truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ValueError(f"lz4 frame: bad magic 0x{magic:08x}")
        if i + 2 > n:
            raise ValueError("lz4 frame: truncated frame descriptor")
        flg = buf[i]
        bd = buf[i + 1]
        if (flg >> 6) != 1:
            raise ValueError(f"lz4 frame: unsupported version {flg >> 6}")
        block_independent = bool(flg & 0x20)
        block_checksum = bool(flg & 0x10)
        has_content_size = bool(flg & 0x08)
        content_checksum = bool(flg & 0x04)
        dict_id = bool(flg & 0x01)
        if not (4 <= (bd >> 4) & 0x7 <= 7):
            raise ValueError("lz4 frame: bad block-size id")
        desc_len = 2 + (8 if has_content_size else 0) + (4 if dict_id else 0)
        if i + desc_len + 1 > n:
            raise ValueError("lz4 frame: truncated frame descriptor")
        declared_size = (
            struct.unpack_from("<Q", buf, i + 2)[0] if has_content_size else None
        )
        hc = buf[i + desc_len]
        if hc != (xxh32(buf[i : i + desc_len]) >> 8) & 0xFF:
            raise ValueError("lz4 frame: header checksum mismatch")
        i += desc_len + 1
        frame_start = len(out)
        while True:
            word = u32(i, "block size")
            i += 4
            if word == 0:  # EndMark
                break
            stored = bool(word & 0x80000000)
            size = word & 0x7FFFFFFF
            block = buf[i : i + size]
            if len(block) != size:
                raise ValueError("lz4 frame: truncated block")
            i += size
            if block_checksum:
                want = u32(i, "block checksum")
                i += 4
                if xxh32(block) != want:
                    raise ValueError("lz4 frame: block checksum mismatch")
            if stored:
                out += block
            else:
                decompress_block(
                    block,
                    out,
                    window_start=len(out) if block_independent else frame_start,
                )
        if content_checksum:
            want = u32(i, "content checksum")
            i += 4
            if xxh32(bytes(out[frame_start:])) != want:
                raise ValueError("lz4 frame: content checksum mismatch")
        if declared_size is not None and len(out) - frame_start != declared_size:
            raise ValueError(
                "lz4 frame: content size mismatch "
                f"(declared {declared_size}, decoded {len(out) - frame_start})"
            )
    return bytes(out)
