"""rosbag -> NPZ scan-sequence converter: the on-ramp for real recorded data.

PyTorch-port counterpart of vofod_tpu/tools/bag_to_npz.py, on the port's
own bag reader, sensor and TF code; the conversion runs on the host only
(ranges, intensity and poses), so it takes no device.

The reference is validated by rosbag replay (launch/detect.launch:8-10,64-84,
``rosbag_remap``); this tool converts a recorded bag of organized Ouster
clouds + TF into the NPZ replay format consumed by ``VoFOD.replay`` /
``tools/detect.py`` (io/scan_source.save_scans_npz), so recorded data can be
evaluated without ROS at runtime.

Bags are read with the ``rosbag`` package when it imports (a ROS machine),
else with the pure-Python io/rosbag_lite.py (none / bz2 / lz4 chunks); the
conversion math is pure and unit-tested (:func:`organized_cloud_to_scan`,
:func:`accumulate_tf`).

Usage:
  python -m vofod_tpu_torch.tools.bag_to_npz input.bag out.npz \
      --pointcloud-topic /os_cloud_node/points --world-frame world \
      [--destagger --metadata os_metadata.json]
"""

from __future__ import annotations

import argparse

import numpy as np

from vofod_tpu_torch.runtime.ros_adapter import transform_to_pose
from vofod_tpu_torch.sensor import destagger as destagger_img


def organized_cloud_to_scan(
    fields: dict,
    height: int,
    width: int,
    pixel_shift_by_row=None,
    do_destagger: bool = False,
) -> np.ndarray:
    """Organized-cloud field dict -> flat [H*W] ranges_mm (uint32).

    ``fields`` carries 'range' (mm, preferred — the raw Ouster channel the
    reference consumes, vofod_nodelet.cpp:1455) or 'xyz' ([H*W, 3], converted
    to ranges).  With ``do_destagger`` the image is destaggered by
    ``pixel_shift_by_row`` (sensor.destagger; ref pixel_shift_by_row usage
    :527-543) — use when the bag carries staggered raw frames but the LUT was
    built for destaggered pixel order.
    """
    if "range" in fields:
        r = np.asarray(fields["range"], np.uint32).reshape(height, width)
    else:
        xyz = np.asarray(fields["xyz"], np.float64).reshape(height, width, 3)
        rr = np.linalg.norm(xyz, axis=-1)
        rr[~np.isfinite(rr)] = 0.0
        r = np.round(rr * 1000.0).astype(np.uint32)
    if do_destagger:
        if pixel_shift_by_row is None:
            raise ValueError("destagger requested but no pixel_shift_by_row")
        r = destagger_img(r, pixel_shift_by_row)
    return r.reshape(-1)


def accumulate_tf(
    tf_msgs: list[dict], world_frame: str, sensor_frame: str
) -> "_TfChain":
    """Build a pose lookup from a list of transform dicts
    {'stamp', 'parent', 'child', 'txyz': (3,), 'quat': (x,y,z,w)}.

    Supports a chain world->...->sensor by composing the latest transform of
    each edge at or before the query stamp (the simple forward-kinematics
    subset of tf2 the reference setup needs: map->uav->sensor).
    """
    return _TfChain(tf_msgs, world_frame, sensor_frame)


class _TfChain:
    def __init__(self, tf_msgs, world_frame, sensor_frame):
        self.world = world_frame
        self.sensor = sensor_frame
        # per edge (parent, child): sorted [(stamp, 4x4)]
        self.edges: dict[tuple[str, str], list] = {}
        for m in tf_msgs:
            T = transform_to_pose(*m["txyz"], *m["quat"])
            self.edges.setdefault(
                (m["parent"].lstrip("/"), m["child"].lstrip("/")), []
            ).append((float(m["stamp"]), T))
        for v in self.edges.values():
            v.sort(key=lambda t: t[0])
        # resolve the parent chain sensor -> ... -> world once
        self.chain = self._find_chain()

    def _find_chain(self):
        parents = {c: p for (p, c) in self.edges}
        chain = []
        cur = self.sensor
        while cur != self.world:
            if cur not in parents:
                raise ValueError(
                    f"no TF chain {self.world} -> {self.sensor}; "
                    f"edges: {sorted(self.edges)}"
                )
            chain.append((parents[cur], cur))
            cur = parents[cur]
        return list(reversed(chain))  # world-side first

    def lookup(self, stamp: float) -> np.ndarray | None:
        """world_T_sensor using the latest transform per edge at <= stamp
        (falls back to the earliest if the bag starts later)."""
        T = np.eye(4, dtype=np.float32)
        for edge in self.chain:
            entries = self.edges[edge]
            best = entries[0][1]
            for s, m in entries:
                if s <= stamp + 1e-9:
                    best = m
                else:
                    break
            T = T @ best
        return T


# -----------------------------------------------------------------------------
# Bag reading: the `rosbag` package when installed, otherwise the pure-Python
# reader (io/rosbag_lite.py — v2.0 bags with PointCloud2 + TF)
# -----------------------------------------------------------------------------


def _iter_bag_rosbag(bag_path, pointcloud_topic):
    """Yield ('tf', dict) / ('cloud', (stamp, frame, H, W, fields)) via the
    official rosbag package."""
    import rosbag  # ROS machine
    import sensor_msgs.point_cloud2 as pc2

    with rosbag.Bag(bag_path) as bag:
        for topic, msg, _t in bag.read_messages(
            topics=[pointcloud_topic, "/tf", "/tf_static"]
        ):
            if topic in ("/tf", "/tf_static"):
                for tr in msg.transforms:
                    yield "tf", dict(
                        stamp=tr.header.stamp.to_sec(),
                        parent=tr.header.frame_id,
                        child=tr.child_frame_id,
                        txyz=(
                            tr.transform.translation.x,
                            tr.transform.translation.y,
                            tr.transform.translation.z,
                        ),
                        quat=(
                            tr.transform.rotation.x,
                            tr.transform.rotation.y,
                            tr.transform.rotation.z,
                            tr.transform.rotation.w,
                        ),
                    )
            else:
                fields = [f.name for f in msg.fields]
                if "range" in fields:
                    d = {
                        "range": np.array(
                            list(pc2.read_points(msg, field_names=("range",))),
                            np.uint32,
                        )
                    }
                else:
                    d = {
                        "xyz": np.array(
                            list(
                                pc2.read_points(msg, field_names=("x", "y", "z"))
                            ),
                            np.float64,
                        )
                    }
                # the reference gates raycast pixels on intensity
                # (vofod_nodelet.cpp:1449); newer Ouster drivers name the
                # channel "signal"
                for name in ("intensity", "signal"):
                    if name in fields:
                        d["intensity"] = np.array(
                            list(pc2.read_points(msg, field_names=(name,))),
                            np.float32,
                        ).reshape(-1)
                        break
                yield "cloud", (
                    msg.header.stamp.to_sec(),
                    msg.header.frame_id,
                    msg.height,
                    msg.width,
                    d,
                )


def _iter_bag_lite(bag_path, pointcloud_topic):
    """Same stream via the pure-Python reader (no ROS install needed)."""
    from vofod_tpu_torch.io import rosbag_lite

    for bm in rosbag_lite.read_bag(
        bag_path, topics=[pointcloud_topic, "/tf", "/tf_static"]
    ):
        if bm.msg_type == rosbag_lite.TF_TYPE:
            for tr in bm.msg:
                yield "tf", tr
        elif bm.msg_type == rosbag_lite.PC2_TYPE:
            pc = bm.msg
            names = [f[0] for f in pc.fields]
            if "range" in names:
                d = {"range": pc.extract(("range",))["range"]}
            else:
                cols = pc.extract(("x", "y", "z"))
                d = {
                    "xyz": np.stack(
                        [cols["x"], cols["y"], cols["z"]], axis=1
                    ).astype(np.float64)
                }
            for name in ("intensity", "signal"):
                if name in names:
                    d["intensity"] = (
                        pc.extract((name,))[name].astype(np.float32)
                    )
                    break
            yield "cloud", (pc.stamp, pc.frame_id, pc.height, pc.width, d)


def convert_bag(
    bag_path: str,
    out_path: str,
    pointcloud_topic: str,
    world_frame: str = "world",
    sensor_frame: str | None = None,
    do_destagger: bool = False,
    metadata_json: str | None = None,
    max_scans: int | None = None,
) -> int:
    """Read a rosbag and write the NPZ replay file.  Returns #scans."""
    from vofod_tpu_torch.io.scan_source import save_scans_npz

    shift = None
    if metadata_json:
        from vofod_tpu_torch.sensor import parse_ouster_metadata

        with open(metadata_json) as f:
            _, _, shift = parse_ouster_metadata(f.read())

    try:
        import rosbag  # noqa: F401

        stream = _iter_bag_rosbag(bag_path, pointcloud_topic)
    except ImportError:
        stream = _iter_bag_lite(bag_path, pointcloud_topic)

    tf_msgs = []
    clouds = []
    for kind, item in stream:
        if kind == "tf":
            tf_msgs.append(item)
        else:
            clouds.append(item)
            if max_scans and len(clouds) >= max_scans:
                break

    if not clouds:
        raise ValueError(f"no messages on {pointcloud_topic} in {bag_path}")
    sensor_frame = sensor_frame or clouds[0][1].lstrip("/")
    chain = accumulate_tf(tf_msgs, world_frame, sensor_frame)

    ranges, poses, stamps, intens = [], [], [], []
    for stamp, _frame, H, W, d in clouds:
        ranges.append(
            organized_cloud_to_scan(d, H, W, shift, do_destagger)
        )
        if "intensity" in d:
            img = np.asarray(d["intensity"], np.float32).reshape(H, W)
            if do_destagger:
                img = destagger_img(img, shift)
            intens.append(img.reshape(-1))
        poses.append(chain.lookup(stamp))
        stamps.append(stamp)
    save_scans_npz(
        out_path,
        np.stack(ranges),
        np.stack(poses).astype(np.float32),
        np.asarray(stamps),
        # only if EVERY scan carried the channel (mixed bags fall back to
        # the all-pass default, same as the reference with min_intensity=0)
        intensity=np.stack(intens) if len(intens) == len(ranges) else None,
    )
    return len(ranges)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("bag")
    ap.add_argument("out_npz")
    ap.add_argument("--pointcloud-topic", default="/os_cloud_node/points")
    ap.add_argument("--world-frame", default="world")
    ap.add_argument("--sensor-frame", default=None)
    ap.add_argument("--destagger", action="store_true")
    ap.add_argument("--metadata", default=None,
                    help="Ouster metadata JSON (for pixel_shift_by_row)")
    ap.add_argument("--max-scans", type=int, default=None)
    args = ap.parse_args(argv)
    n = convert_bag(
        args.bag, args.out_npz, args.pointcloud_topic, args.world_frame,
        args.sensor_frame, args.destagger, args.metadata, args.max_scans,
    )
    print(f"wrote {n} scans -> {args.out_npz}")


if __name__ == "__main__":
    main()
