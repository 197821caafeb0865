"""COLMAP sparse-reconstruction binary loader, as tpugs/data/colmap.py:
cameras.bin, images.bin and points3D.bin, little endian. Each parser
takes the native C++ loader (data/native.py) unless TPUGS_NATIVE=0 is set
(or USE_NATIVE is False), and then the numpy parse below. Where the native
loader is asked for and cannot be built or loaded, the parser raises: it
never falls back to numpy in silence, as the reference does."""
from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from tpugs_torch.core.camera import CameraInfo, CameraModel, qvec_to_rotmat

# model id -> number of double params (COLMAP convention).
_MODEL_NUM_PARAMS = {
    CameraModel.SIMPLE_PINHOLE: 3,  # f, cx, cy
    CameraModel.PINHOLE: 4,  # fx, fy, cx, cy
    CameraModel.SIMPLE_RADIAL: 4,  # f, cx, cy, k
    CameraModel.RADIAL: 5,  # f, cx, cy, k1, k2
    CameraModel.OPENCV: 8,  # fx, fy, cx, cy, k1, k2, p1, p2
}

# A points3D.bin record with an empty track.
POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                         ("error", "<f8"), ("track_len", "<u8")])


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: CameraModel
    width: int
    height: int
    params: np.ndarray  # double params, model-dependent


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


@dataclasses.dataclass
class SparsePoint:
    xyz: np.ndarray
    rgb: np.ndarray  # uint8


USE_NATIVE = os.environ.get("TPUGS_NATIVE", "1") != "0"


def _native():
    """The native loader module, or None when TPUGS_NATIVE=0 opted out.
    Raises native.NativeUnavailable when it cannot be built or loaded."""
    if not USE_NATIVE:
        return None
    from tpugs_torch.data import native

    native.lib()
    return native


def parse_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    nat = _native()
    if nat is not None:
        cams = {}
        for row in nat.parse_cameras(path):
            model = CameraModel(int(row[1]))
            np_params = _MODEL_NUM_PARAMS[model]
            cams[int(row[0])] = ColmapCamera(
                int(row[0]), model, int(row[2]), int(row[3]),
                row[4: 4 + np_params].copy())
        return cams
    cams: dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    for _ in range(num):
        cam_id, model_id = struct.unpack_from("<ii", buf, off)
        off += 8
        w, h = struct.unpack_from("<QQ", buf, off)
        off += 16
        model = CameraModel(model_id)
        np_params = _MODEL_NUM_PARAMS[model]
        params = np.frombuffer(buf, "<f8", count=np_params, offset=off).copy()
        off += 8 * np_params
        cams[cam_id] = ColmapCamera(cam_id, model, int(w), int(h), params)
    return cams


def parse_images_bin(path: str) -> list[ColmapImage]:
    """Poses and names; the 2D observations are skipped."""
    nat = _native()
    if nat is not None:
        rec, names = nat.parse_images(path)
        return [ColmapImage(int(rec[i, 0]), rec[i, 1:5].copy(),
                            rec[i, 5:8].copy(), int(rec[i, 8]), names[i])
                for i in range(rec.shape[0])]
    images: list[ColmapImage] = []
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    for _ in range(num):
        (image_id,) = struct.unpack_from("<i", buf, off)
        off += 4
        q = np.frombuffer(buf, "<f8", count=4, offset=off).copy()
        off += 32
        t = np.frombuffer(buf, "<f8", count=3, offset=off).copy()
        off += 24
        (camera_id,) = struct.unpack_from("<i", buf, off)
        off += 4
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (num_p2d,) = struct.unpack_from("<Q", buf, off)
        off += 8 + int(num_p2d) * 24  # skip (x, y, point3D_id) triples
        images.append(ColmapImage(image_id, q, t, camera_id, name))
    return images


def parse_points3d_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (xyz [N, 3] float64, rgb [N, 3] uint8); tracks skipped. A file
    whose tracks are all empty is read in one structured view."""
    nat = _native()
    if nat is not None:
        return nat.parse_points3d(path)
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    if len(buf) == 8 + num * POINT_RECORD.itemsize:
        rec = np.frombuffer(buf, POINT_RECORD, count=num, offset=8)
        if not rec["track_len"].any():
            return rec["xyz"].copy(), rec["rgb"].copy()
    off = 8
    xyz = np.empty((num, 3), np.float64)
    rgb = np.empty((num, 3), np.uint8)
    for i in range(num):
        off += 8  # point3D_id
        xyz[i] = np.frombuffer(buf, "<f8", count=3, offset=off)
        off += 24
        rgb[i] = np.frombuffer(buf, "u1", count=3, offset=off)
        off += 3
        off += 8  # reprojection error
        (track_len,) = struct.unpack_from("<Q", buf, off)
        off += 8 + int(track_len) * 8
    return xyz, rgb


def parse_colmap_sparse(sparse_dir: str):
    """The three files of a COLMAP sparse dir."""
    cams = parse_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
    images = parse_images_bin(os.path.join(sparse_dir, "images.bin"))
    xyz, rgb = parse_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    return cams, images, xyz, rgb


def _intrinsics_from_params(model: CameraModel, params: np.ndarray):
    """(fx, fy, cx, cy) per model; distortion params are ignored."""
    if model in (CameraModel.SIMPLE_PINHOLE, CameraModel.SIMPLE_RADIAL,
                 CameraModel.RADIAL):
        f, cx, cy = params[:3]
        return f, f, cx, cy
    if model in (CameraModel.PINHOLE, CameraModel.OPENCV):
        fx, fy, cx, cy = params[:4]
        return fx, fy, cx, cy
    raise ValueError(f"unsupported camera model {model}")


def merge_cameras_images(cams: dict[int, ColmapCamera],
                         images: list[ColmapImage]) -> list[CameraInfo]:
    """Join images with their cameras into posed CameraInfo records."""
    out: list[CameraInfo] = []
    for im in images:
        cam = cams[im.camera_id]
        fx, fy, cx, cy = _intrinsics_from_params(cam.model, cam.params)
        out.append(CameraInfo(
            image_name=im.name, width=cam.width, height=cam.height,
            fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
            R=qvec_to_rotmat(im.qvec), t=im.tvec.astype(np.float64),
            camera_id=im.camera_id,
        ))
    return out
