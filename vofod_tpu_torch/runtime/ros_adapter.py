"""Optional ROS 1 adapter: maps the port onto the reference's topics.

PyTorch-port counterpart of vofod_tpu/runtime/ros_adapter.py.  The
reference is a ROS Noetic nodelet (nodelets.xml, launch/detect.launch);
this adapter reproduces its wire interface on top of the port's node
(runtime/node.py) when ``rospy`` is importable.  rospy and the message
modules are imported only inside the classes, so the module imports
without ROS; the pure conversion functions are the JAX adapter's.

Topic mapping (ref vofod_nodelet.cpp:241-278, launch/detect.launch:58-88):
  in : ~pointcloud (sensor_msgs/PointCloud2, organized HxW, 'range' field)
  in : ~height_rangefinder (sensor_msgs/Range — the reference's subscriber
       name, vofod_nodelet.cpp:248; detect.launch remaps it to the UAV's
       garmin topic)
  out: ~detections_json (std_msgs/String — vofod/Detections content; the mrs
       message package is not a dependency here)
  out: ~status_json (std_msgs/String — vofod/Status content, 10 Hz)
  out: ~profiling_info_json (std_msgs/String — vofod/ProfilingInfo events)
  out: ~detections_mks (visualization_msgs/MarkerArray — detection spheres,
       ref ~det_mks :996)
  out: ~background_pc / ~sure_air_pc (sensor_msgs/PointCloud2 debug clouds,
       ref :1001-1016), published on the 10 Hz status timer when subscribed
  srv: ~reset (std_srvs/Trigger, ref reset_callback :566-572)

Remapping: ``remap={"~pointcloud": "/uav1/os_cloud_nodelet/points", ...}``
reproduces the launch-file ``<remap>`` lines, and ``topic_suffix="_"``
reproduces the ``rosbag_remap`` argument (every *output* topic gets the
suffix so replayed bags don't collide with live topics,
launch/detect.launch:8-10, 64-84; subscriptions and the reset service are
never suffixed, matching the launch file).

TF lookups that fail are logged loudly and counted (the reference warns per
failure, vofod_nodelet.cpp:913-923) — scans are never silently dropped.

The reference's SECOND nodelet, vofod/MaskCreator, has its own wire surface
here too (:class:`RosMaskCreator` — src/mask_creator.cpp:63-76):
  in : ~pointcloud (the same organized cloud)
  out: ~mask (sensor_msgs/Image mono8, 255 = usable, published at 20 Hz)
  srv: ~save / ~reset (std_srvs/Trigger)
"""

from __future__ import annotations

import json
import logging

import numpy as np

from vofod_tpu_torch.runtime.node import VoFOD

_log = logging.getLogger("vofod_tpu_torch.ros")


def ros_available() -> bool:
    try:
        import rospy  # noqa: F401

        return True
    except ImportError:
        return False


# -----------------------------------------------------------------------------
# Pure converters (testable without ROS)
# -----------------------------------------------------------------------------


def pointcloud2_to_ranges(msg_fields: dict, height: int, width: int) -> np.ndarray:
    """Convert an organized cloud dict {'range': [H*W] mm or 'xyz': [H*W,3]}
    to the ranges_mm vector the pipeline consumes."""
    if "range" in msg_fields:
        return np.asarray(msg_fields["range"], np.uint32).reshape(-1)
    xyz = np.asarray(msg_fields["xyz"], np.float64).reshape(-1, 3)
    r = np.linalg.norm(xyz, axis=1)
    r[~np.isfinite(r)] = 0.0
    return np.round(r * 1000.0).astype(np.uint32)


def quat_to_matrix(x: float, y: float, z: float, w: float) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation matrix."""
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def transform_to_pose(tx, ty, tz, qx, qy, qz, qw) -> np.ndarray:
    """TF translation + quaternion -> 4x4 world_T_sensor."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
    T[:3, 3] = (tx, ty, tz)
    return T


def detections_to_json(out) -> str:
    """io.msgs.Detections -> the ~detections_json payload."""
    return json.dumps(
        {
            "stamp": out.header.stamp,
            "frame_id": out.header.frame_id,
            "detections": [vars(d) for d in out.detections],
        },
        default=str,
    )


def status_to_json(status, stamp: float) -> str:
    """io.msgs.Status -> the ~status_json payload (ref Status.msg)."""
    return json.dumps(
        {
            "stamp": stamp,
            "detection_enabled": status.detection_enabled,
            "detection_active": status.detection_active,
        }
    )


def profiling_event_to_json(evt) -> str:
    """io.msgs.ProfilingInfo -> the ~profiling_info_json payload."""
    return json.dumps(
        {
            "stamp": evt.stamp,
            "routine_id": evt.routine_id,
            "event_sequence": evt.event_sequence,
            "event_type": evt.event_type,
        }
    )


def _extract_ranges(msg) -> np.ndarray:
    """Organized PointCloud2 -> [H*W] uint32 ranges (mm): the 'range' field
    when present (the Ouster driver's native channel, what the reference's
    pc_t carries), else recomputed from xyz."""
    import sensor_msgs.point_cloud2 as pc2

    fields = [f.name for f in msg.fields]
    if "range" in fields:
        return np.array(
            list(pc2.read_points(msg, field_names=("range",))), np.uint32
        ).reshape(-1)
    xyz = np.array(
        list(pc2.read_points(msg, field_names=("x", "y", "z"))), np.float64
    )
    return pointcloud2_to_ranges({"xyz": xyz}, msg.height, msg.width)


# -----------------------------------------------------------------------------
# The rospy node
# -----------------------------------------------------------------------------


class RosNode:
    """rospy wrapper; constructed only when ROS is present."""

    def __init__(self, detector: VoFOD, tf_frame: str = "world",
                 status_rate_hz: float = 10.0,
                 remap: dict | None = None, topic_suffix: str = ""):
        if not ros_available():
            raise RuntimeError(
                "rospy not available — use vofod_tpu_torch.runtime.node.VoFOD directly"
            )
        import rospy
        from sensor_msgs.msg import PointCloud2, Range
        from std_msgs.msg import String
        from std_srvs.srv import Trigger

        self.det = detector
        self.tf_frame = tf_frame
        self.tf_failures = 0
        remap = remap or {}
        # subscriptions/services: remap only; outputs: remap, then suffix
        # (the rosbag_remap behavior — launch/detect.launch:64-84)
        sub = lambda name: remap.get(name, name)
        out = lambda name: remap.get(name, name) + topic_suffix
        rospy.Subscriber(sub("~pointcloud"), PointCloud2, self._pc_cb,
                         queue_size=2)
        rospy.Subscriber(sub("~height_rangefinder"), Range, self._rf_cb,
                         queue_size=2)
        self._srv = rospy.Service(sub("~reset"), Trigger, self._reset_cb)
        self._pub_det = rospy.Publisher(out("~detections_json"), String,
                                        queue_size=2)
        self._pub_status = rospy.Publisher(out("~status_json"), String,
                                           queue_size=2)
        self._pub_prof = rospy.Publisher(
            out("~profiling_info_json"), String, queue_size=16
        )
        try:
            from visualization_msgs.msg import MarkerArray

            self._pub_mks = rospy.Publisher(
                out("~detections_mks"), MarkerArray, queue_size=2
            )
        except ImportError:
            self._pub_mks = None
        self._pub_bg_pc = rospy.Publisher(out("~background_pc"), PointCloud2,
                                          queue_size=1)
        self._pub_air_pc = rospy.Publisher(out("~sure_air_pc"), PointCloud2,
                                           queue_size=1)
        # wire the detector's profiling stream straight to the topic
        self.det.profiling.set_publisher(
            lambda evt: self._pub_prof.publish(
                String(data=profiling_event_to_json(evt))
            )
        )
        # 10 Hz status/markers loop (ref main_loop, vofod_nodelet.cpp:1331-1386)
        self._timer = rospy.Timer(
            rospy.Duration(1.0 / status_rate_hz), self._status_cb
        )

    def _reset_cb(self, _req):
        from std_srvs.srv import TriggerResponse

        self.det.reset()
        return TriggerResponse(success=True, message="Detector reset.")

    def _pc_cb(self, msg):
        import sensor_msgs.point_cloud2 as pc2
        from std_msgs.msg import String

        fields = [f.name for f in msg.fields]
        ranges = _extract_ranges(msg)
        # intensity gates raycast pixels (ref vofod_nodelet.cpp:1449);
        # newer Ouster drivers name the channel "signal"
        inten = None
        for name in ("intensity", "signal"):
            if name in fields:
                inten = np.array(
                    list(pc2.read_points(msg, field_names=(name,))), np.float32
                ).reshape(-1)
                break
        pose = self._lookup_pose(msg.header)
        if pose is None:
            return  # already logged loudly by _lookup_pose
        out = self.det.process_scan(ranges, inten, pose,
                                    msg.header.stamp.to_sec())
        self._pub_det.publish(String(data=detections_to_json(out)))
        if self._pub_mks is not None and self._pub_mks.get_num_connections():
            self._pub_mks.publish(self._detection_markers(out, msg.header))

    def _rf_cb(self, msg):
        pose = self._lookup_pose(msg.header)
        if pose is not None:
            self.det.process_rangefinder(
                msg.range, msg.min_range, msg.max_range, pose
            )

    def _status_cb(self, _evt):
        import rospy
        from std_msgs.msg import String

        self._pub_status.publish(
            String(data=status_to_json(self.det.status(), rospy.get_time()))
        )
        if self._pub_bg_pc.get_num_connections():
            thr = float(self.det.dyn.thr_new_obstacles)
            self._pub_bg_pc.publish(
                self._xyz_cloud(self.det.export_voxels(thr, above=True))
            )
        if self._pub_air_pc.get_num_connections():
            # "sure air": below the frontiers threshold (ref ~sure_air_pc)
            thr = float(self.det.dyn.thr_frontiers)
            self._pub_air_pc.publish(
                self._xyz_cloud(self.det.export_voxels(thr, above=False))
            )

    # ------------------------------------------------------------------ helpers
    def _detection_markers(self, out, header):
        """Detection spheres (ref detection markers, vofod_nodelet.cpp:996)."""
        from visualization_msgs.msg import Marker, MarkerArray

        arr = MarkerArray()
        for d in out.detections:
            m = Marker()
            m.header.frame_id = self.tf_frame
            m.header.stamp = header.stamp
            m.ns = "vofod_detections"
            m.id = d.id
            m.type = Marker.SPHERE
            m.action = Marker.ADD
            m.pose.position.x, m.pose.position.y, m.pose.position.z = d.position
            m.pose.orientation.w = 1.0
            m.scale.x = m.scale.y = m.scale.z = 1.0
            m.color.r, m.color.a = 1.0, max(0.2, float(d.confidence))
            arr.markers.append(m)
        return arr

    def _xyz_cloud(self, pts: np.ndarray):
        import rospy
        import sensor_msgs.point_cloud2 as pc2
        from std_msgs.msg import Header as RosHeader

        h = RosHeader()
        h.stamp = rospy.Time.now()
        h.frame_id = self.tf_frame
        return pc2.create_cloud_xyz32(h, pts.tolist())

    def _lookup_pose(self, header):
        import rospy

        try:
            import tf2_ros

            if not hasattr(self, "_tf_buf"):
                self._tf_buf = tf2_ros.Buffer()
                self._tf_listener = tf2_ros.TransformListener(self._tf_buf)
            t = self._tf_buf.lookup_transform(
                self.tf_frame, header.frame_id.lstrip("/"), header.stamp
            )
            return transform_to_pose(
                t.transform.translation.x,
                t.transform.translation.y,
                t.transform.translation.z,
                t.transform.rotation.x,
                t.transform.rotation.y,
                t.transform.rotation.z,
                t.transform.rotation.w,
            )
        except Exception as e:  # the reference warns per failure (ref :913-923)
            self.tf_failures += 1
            rospy.logwarn_throttle(
                1.0,
                f"[VoFOD]: TF lookup {header.frame_id} -> {self.tf_frame} "
                f"failed ({e}); dropping message ({self.tf_failures} so far)",
            )
            return None


# -----------------------------------------------------------------------------
# The MaskCreator nodelet's wire surface
# -----------------------------------------------------------------------------


class RosMaskCreator:
    """The reference's SECOND nodelet, vofod/MaskCreator
    (src/mask_creator.cpp:63-76, 193-260): accumulate an FOV mask from live
    scans (any pixel that ever returns range == 0 is marked occluded,
    cloud_callback :217-235), publish the current mask as a mono8 image at
    20 Hz (display_loop :164-189 sleeps 0.05 s between publishes), and expose
    ``~save`` / ``~reset`` Trigger services (:193-211).

    The accumulator itself is runtime.mask_creator.MaskCreator (a bool
    tensor on the device); this class is only the rospy shell, with the same remap /
    rosbag-suffix semantics as RosNode.
    """

    def __init__(self, creator, mask_fname: str = "mask.png",
                 publish_rate_hz: float = 20.0,
                 remap: dict | None = None, topic_suffix: str = ""):
        if not ros_available():
            raise RuntimeError(
                "rospy not available — use runtime.mask_creator.MaskCreator "
                "directly (tools/create_mask.py is the offline CLI)"
            )
        import rospy
        from sensor_msgs.msg import Image, PointCloud2
        from std_srvs.srv import Trigger

        self.mc = creator
        self.mask_fname = mask_fname  # ref param mask_fname (:50-56)
        remap = remap or {}
        sub = lambda name: remap.get(name, name)
        out = lambda name: remap.get(name, name) + topic_suffix
        rospy.Subscriber(sub("~pointcloud"), PointCloud2, self._pc_cb,
                         queue_size=2)
        self._pub_mask = rospy.Publisher(out("~mask"), Image, queue_size=1)
        self._srv_reset = rospy.Service(sub("~reset"), Trigger, self._reset_cb)
        self._srv_save = rospy.Service(sub("~save"), Trigger, self._save_cb)
        self._timer = rospy.Timer(
            rospy.Duration(1.0 / publish_rate_hz), self._display_cb
        )

    def _pc_cb(self, msg):
        self.mc.add_scan(_extract_ranges(msg))

    def _display_cb(self, _evt):
        import rospy
        from sensor_msgs.msg import Image

        m = self.mc.mask() * np.uint8(255)  # 255 = usable, like the cv::Mat
        img = Image()
        img.header.stamp = rospy.Time.now()
        img.height, img.width = m.shape
        img.encoding = "mono8"
        img.is_bigendian = 0
        img.step = m.shape[1]
        img.data = m.tobytes()
        self._pub_mask.publish(img)

    def _reset_cb(self, _req):
        from std_srvs.srv import TriggerResponse

        self.mc.reset()
        return TriggerResponse(success=True, message="Mask reset.")

    def _save_cb(self, _req):
        from std_srvs.srv import TriggerResponse

        self.mc.save(self.mask_fname)
        return TriggerResponse(success=True, message="Mask saved.")
