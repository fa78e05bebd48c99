"""Minimal pure-Python rosbag v2.0 reader/writer (none/bz2/lz4 chunks).

A copy of vofod_tpu/io/rosbag_lite.py for the PyTorch port (importing
vofod_tpu loads JAX), with lz4 through the port's own ``io/lz4_lite``;
tests/test_torch_shared_copies.py holds it to the original.

The reference is validated by rosbag replay (launch/detect.launch:8-10,
``rosbag_remap``); its recorded bags carry organized Ouster clouds
(sensor_msgs/PointCloud2 with the raw ``range`` channel,
vofod_nodelet.cpp:1455) and TF (tf2_msgs/TFMessage).  This module implements
exactly that subset of the rosbag 2.0 container and ROS1 message wire
formats, so tools/bag_to_npz.py can ingest real recorded bags WITHOUT a ROS
install (the ``rosbag`` package, when importable, still takes priority), and
tests can author rosbag-format fixtures.

Format per the rosbag 2.0 spec (wiki.ros.org/Bags/Format/2.0): records of
header+data blobs; ops used: 0x03 bag header, 0x05 chunk (compression
"none"/"bz2"/"lz4" both ways — roslz4 emits the standard LZ4 frame format,
handled by the pure-Python ``io/lz4_lite`` codec, or by the real ``lz4``
package when importable), 0x07 connection,
0x02 message data, 0x04 index data, 0x06 chunk info.  The writer emits a properly indexed bag (index_pos, per-chunk index
records, trailing connection + chunk-info section) so the official tooling
accepts the output too.

Message types supported: sensor_msgs/PointCloud2, tf2_msgs/TFMessage
(md5sums are the upstream constants).  Unknown connections are skipped on
read.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"


def _lz4_decompress(data: bytes) -> bytes:
    try:
        import lz4.frame

        return lz4.frame.decompress(data)
    except ImportError:
        from vofod_tpu_torch.io import lz4_lite

        return lz4_lite.decompress(data)


def _lz4_compress(data: bytes) -> bytes:
    try:
        import lz4.frame

        return lz4.frame.compress(data)
    except ImportError:
        from vofod_tpu_torch.io import lz4_lite

        return lz4_lite.compress(data)

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

PC2_TYPE = "sensor_msgs/PointCloud2"
PC2_MD5 = "1158d486dd51d683ce2f1be655c3c181"
TF_TYPE = "tf2_msgs/TFMessage"
TF_MD5 = "94810edda583a504dfda3829e70d7eec"

# PointField datatype codes (sensor_msgs/PointField)
PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}
PF_CODE = {np.dtype(v): k for k, v in PF_DTYPES.items()}


# =============================================================================
# record-level encoding
# =============================================================================


def _fields(d: dict) -> bytes:
    out = b""
    for k, v in d.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _u32(v):
    return struct.pack("<I", v)


def _u64(v):
    return struct.pack("<Q", v)


def _time(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    return struct.pack("<II", secs, nsecs)


def _record(header: dict, data: bytes) -> bytes:
    h = _fields(header)
    return _u32(len(h)) + h + _u32(len(data)) + data


def _parse_fields(buf: bytes) -> dict:
    """Parse a record header's name=value fields; truncated/lying field
    lengths raise ValueError (never a silent short slice)."""
    out = {}
    i = 0
    while i < len(buf):
        if i + 4 > len(buf):
            raise ValueError("rosbag: truncated field length")
        (n,) = struct.unpack_from("<I", buf, i)
        i += 4
        if i + n > len(buf):
            raise ValueError(
                f"rosbag: field length {n} overruns the header "
                f"({len(buf) - i} bytes left)"
            )
        item = buf[i : i + n]
        i += n
        k, _, v = item.partition(b"=")
        out[k.decode(errors="replace")] = v
    return out


def _read_record(buf: bytes, i: int) -> tuple[dict, bytes, int]:
    """Read one header+data record at offset ``i``; every length field is
    validated against the remaining bytes, so truncated records raise
    ValueError instead of struct.error / silently-short data."""
    n = len(buf)
    if i + 4 > n:
        raise ValueError("rosbag: truncated record (header length)")
    (hl,) = struct.unpack_from("<I", buf, i)
    if i + 4 + hl > n:
        raise ValueError(f"rosbag: record header length {hl} overruns the file")
    header = _parse_fields(buf[i + 4 : i + 4 + hl])
    i += 4 + hl
    if i + 4 > n:
        raise ValueError("rosbag: truncated record (data length)")
    (dl,) = struct.unpack_from("<I", buf, i)
    if i + 4 + dl > n:
        raise ValueError(f"rosbag: record data length {dl} overruns the file")
    data = buf[i + 4 : i + 4 + dl]
    return header, data, i + 4 + dl


# =============================================================================
# ROS1 message wire format (the two types the reference records)
# =============================================================================


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return _u32(len(b)) + b


def _ser_header(seq: int, stamp: float, frame_id: str) -> bytes:
    return _u32(seq) + _time(stamp) + _ser_string(frame_id)


def serialize_pointcloud2(
    stamp: float,
    frame_id: str,
    height: int,
    width: int,
    fields: list[tuple[str, int, int, int]],  # (name, offset, datatype, count)
    point_step: int,
    data: bytes,
    seq: int = 0,
    is_dense: bool = True,
) -> bytes:
    out = _ser_header(seq, stamp, frame_id)
    out += _u32(height) + _u32(width)
    out += _u32(len(fields))
    for name, off, dt, cnt in fields:
        out += _ser_string(name) + _u32(off) + bytes([dt]) + _u32(cnt)
    out += b"\x00"  # is_bigendian
    out += _u32(point_step) + _u32(point_step * width)
    out += _u32(len(data)) + data
    out += b"\x01" if is_dense else b"\x00"
    return out


def serialize_tf_message(transforms: list[dict]) -> bytes:
    """transforms: [{'stamp', 'parent', 'child', 'txyz': (3,), 'quat': (4,)}]."""
    out = _u32(len(transforms))
    for t in transforms:
        out += _ser_header(0, t["stamp"], t["parent"])
        out += _ser_string(t["child"])
        out += struct.pack("<3d", *t["txyz"])
        out += struct.pack("<4d", *t["quat"])
    return out


class _Cursor:
    """Bounds-checked little-endian reader: truncated message payloads raise
    ValueError (never struct.error / IndexError / a silent short read)."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def _need(self, n):
        if self.i + n > len(self.buf):
            raise ValueError(
                f"rosbag: truncated message (need {n} bytes at {self.i}, "
                f"have {len(self.buf) - self.i})"
            )

    def u32(self):
        self._need(4)
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def u8(self):
        self._need(1)
        v = self.buf[self.i]
        self.i += 1
        return v

    def time(self):
        self._need(8)
        s, ns = struct.unpack_from("<II", self.buf, self.i)
        self.i += 8
        return s + ns * 1e-9

    def string(self):
        n = self.u32()
        self._need(n)
        v = self.buf[self.i : self.i + n].decode(errors="replace")
        self.i += n
        return v

    def raw(self, n):
        self._need(n)
        v = self.buf[self.i : self.i + n]
        self.i += n
        return v

    def f64s(self, n):
        self._need(8 * n)
        v = struct.unpack_from(f"<{n}d", self.buf, self.i)
        self.i += 8 * n
        return v


@dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    height: int
    width: int
    fields: list  # (name, offset, datatype, count)
    point_step: int
    data: bytes
    is_dense: bool = True

    def extract(self, names: tuple[str, ...]) -> dict[str, np.ndarray]:
        """Per-point columns for the named fields ([H*W] arrays)."""
        raw = np.frombuffer(self.data, np.uint8).reshape(-1, self.point_step)
        out = {}
        byname = {f[0]: f for f in self.fields}
        for name in names:
            _, off, dt, _cnt = byname[name]
            dtype = np.dtype(PF_DTYPES[dt])
            w = dtype.itemsize
            out[name] = (
                raw[:, off : off + w].copy().view(dtype).reshape(-1)
            )
        return out


def deserialize_pointcloud2(data: bytes) -> PointCloud2:
    c = _Cursor(data)
    c.u32()  # seq
    stamp = c.time()
    frame_id = c.string()
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        off = c.u32()
        dt = c.u8()
        cnt = c.u32()
        fields.append((name, off, dt, cnt))
    c.u8()  # is_bigendian
    point_step = c.u32()
    c.u32()  # row_step
    nd = c.u32()
    payload = c.raw(nd)
    is_dense = bool(c.u8())
    return PointCloud2(
        stamp, frame_id, height, width, fields, point_step, payload, is_dense
    )


def deserialize_tf_message(data: bytes) -> list[dict]:
    c = _Cursor(data)
    n = c.u32()
    out = []
    for _ in range(n):
        c.u32()  # seq
        stamp = c.time()
        parent = c.string()
        child = c.string()
        txyz = c.f64s(3)
        quat = c.f64s(4)
        out.append(
            dict(stamp=stamp, parent=parent, child=child, txyz=txyz, quat=quat)
        )
    return out


# =============================================================================
# Writer
# =============================================================================


@dataclass
class _Conn:
    cid: int
    topic: str
    msg_type: str
    md5: str


class BagWriter:
    """Indexed rosbag v2.0 writer (one chunk per bag — the
    fixture/offline-conversion scale this serves).

    ``compression``: "none" (default), "bz2" or "lz4" — the same modes
    ``rosbag record`` offers (lz4 via io/lz4_lite, or the real ``lz4``
    package when importable)."""

    def __init__(self, path: str, compression: str = "none"):
        if compression not in ("none", "bz2", "lz4"):
            raise ValueError(f"unsupported compression {compression!r}")
        self.path = path
        self.compression = compression
        self.conns: dict[str, _Conn] = {}
        self.msgs: list[tuple[int, float, bytes]] = []  # (cid, stamp, bytes)

    def _conn(self, topic: str, msg_type: str, md5: str) -> _Conn:
        if topic not in self.conns:
            self.conns[topic] = _Conn(len(self.conns), topic, msg_type, md5)
        return self.conns[topic]

    def write_pointcloud2(self, topic: str, stamp: float, **kw):
        c = self._conn(topic, PC2_TYPE, PC2_MD5)
        self.msgs.append(
            (c.cid, stamp, serialize_pointcloud2(stamp=stamp, **kw))
        )

    def write_tf(self, topic: str, stamp: float, transforms: list[dict]):
        c = self._conn(topic, TF_TYPE, TF_MD5)
        self.msgs.append((c.cid, stamp, serialize_tf_message(transforms)))

    def _conn_record(self, c: _Conn) -> bytes:
        conn_hdr = _fields(
            {
                "topic": c.topic.encode(),
                "type": c.msg_type.encode(),
                "md5sum": c.md5.encode(),
                "message_definition": f"# {c.msg_type}\n".encode(),
            }
        )
        return _record(
            {"op": bytes([OP_CONNECTION]), "conn": _u32(c.cid),
             "topic": c.topic.encode()},
            conn_hdr,
        )

    def close(self):
        msgs = sorted(self.msgs, key=lambda m: m[1])
        start, end = (msgs[0][1], msgs[-1][1]) if msgs else (0.0, 0.0)

        # chunk payload: connections then messages, tracking index offsets
        chunk = b""
        index: dict[int, list[tuple[float, int]]] = {}
        for c in self.conns.values():
            chunk += self._conn_record(c)
        for cid, stamp, data in msgs:
            index.setdefault(cid, []).append((stamp, len(chunk)))
            chunk += _record(
                {"op": bytes([OP_MSG]), "conn": _u32(cid), "time": _time(stamp)},
                data,
            )

        with open(self.path, "wb") as f:
            f.write(MAGIC)
            # bag header record padded to 4096 bytes total
            bag_hdr = {
                "op": bytes([OP_BAG_HEADER]),
                "index_pos": _u64(0),  # patched below
                "conn_count": _u32(len(self.conns)),
                "chunk_count": _u32(1),
            }
            hdr_record_len = len(_record(bag_hdr, b""))
            pad = b" " * (4096 - hdr_record_len)
            bag_header_pos = f.tell()
            f.write(_record(bag_hdr, pad))

            chunk_pos = f.tell()
            if self.compression == "bz2":
                payload = bz2.compress(chunk)
            elif self.compression == "lz4":
                payload = _lz4_compress(chunk)
            else:
                payload = chunk
            f.write(
                _record(
                    {
                        "op": bytes([OP_CHUNK]),
                        "compression": self.compression.encode(),
                        # per spec: size = UNcompressed chunk size
                        "size": _u32(len(chunk)),
                    },
                    payload,
                )
            )
            for cid, entries in sorted(index.items()):
                data = b"".join(_time(s) + _u32(off) for s, off in entries)
                f.write(
                    _record(
                        {
                            "op": bytes([OP_INDEX]),
                            "ver": _u32(1),
                            "conn": _u32(cid),
                            "count": _u32(len(entries)),
                        },
                        data,
                    )
                )

            index_pos = f.tell()
            for c in self.conns.values():
                f.write(self._conn_record(c))
            info_data = b"".join(
                _u32(cid) + _u32(len(entries))
                for cid, entries in sorted(index.items())
            )
            f.write(
                _record(
                    {
                        "op": bytes([OP_CHUNK_INFO]),
                        "ver": _u32(1),
                        "chunk_pos": _u64(chunk_pos),
                        "start_time": _time(start),
                        "end_time": _time(end),
                        "count": _u32(len(index)),
                    },
                    info_data,
                )
            )
            # patch index_pos in the bag header
            f.seek(bag_header_pos)
            bag_hdr["index_pos"] = _u64(index_pos)
            f.write(_record(bag_hdr, pad))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# =============================================================================
# Reader
# =============================================================================


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float
    msg: object  # PointCloud2 | list[dict] (TF transforms)


def read_bag(path: str, topics: list[str] | None = None):
    """Yield BagMessage for every decodable message, in file order.

    Sequential chunk scan (no index needed).  Chunk compression "none",
    "bz2" and "lz4" all work with no external packages (lz4 via the
    pure-Python io/lz4_lite frame codec; the real ``lz4`` package takes
    priority when importable)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(MAGIC):
        raise ValueError(f"{path!r} is not a rosbag v2.0 file")
    conns: dict[int, tuple[str, str]] = {}  # cid -> (topic, type)

    def u32_field(header, name):
        v = header.get(name)
        if v is None or len(v) != 4:
            raise ValueError(f"rosbag: record missing/short {name!r} field")
        return struct.unpack("<I", v)[0]

    def handle(header, data):
        op_bytes = header.get("op", b"")
        if len(op_bytes) != 1:
            raise ValueError("rosbag: record missing the 1-byte op field")
        op = op_bytes[0]
        if op == OP_CONNECTION:
            cid = u32_field(header, "conn")
            ch = _parse_fields(data)
            if "topic" not in ch or "type" not in ch:
                raise ValueError("rosbag: connection record missing topic/type")
            conns[cid] = (ch["topic"].decode(), ch["type"].decode())
        elif op == OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "bz2":
                data = bz2.decompress(data)
            elif comp == "lz4":
                data = _lz4_decompress(data)
            elif comp != "none":
                raise NotImplementedError(
                    f"compressed chunk ({comp}); run `rosbag decompress` first"
                )
            # per spec the size field is the UNcompressed chunk size; a
            # disagreeing value means corruption (or a lying encoder)
            if "size" in header and u32_field(header, "size") != len(data):
                raise ValueError(
                    f"rosbag: chunk size field {u32_field(header, 'size')} "
                    f"!= decompressed length {len(data)}"
                )
            j = 0
            while j < len(data):
                h2, d2, j = _read_record(data, j)
                yield from handle(h2, d2)
        elif op == OP_MSG:
            cid = u32_field(header, "conn")
            t = header.get("time", b"")
            if len(t) != 8:
                raise ValueError("rosbag: message record missing/short time")
            secs, nsecs = struct.unpack("<II", t)
            stamp = secs + nsecs * 1e-9
            topic, msg_type = conns.get(cid, ("?", "?"))
            if topics and topic not in topics:
                return
            if msg_type == PC2_TYPE:
                yield BagMessage(
                    topic, msg_type, stamp, deserialize_pointcloud2(data)
                )
            elif msg_type == TF_TYPE:
                yield BagMessage(
                    topic, msg_type, stamp, deserialize_tf_message(data)
                )
        # op 3/4/6: bag header / index / chunk info — not needed sequentially

    i = len(MAGIC)
    while i < len(buf):
        header, data, i = _read_record(buf, i)
        yield from handle(header, data)
