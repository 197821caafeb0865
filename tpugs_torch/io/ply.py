"""3DGS-compatible gaussian PLY I/O (numpy), as in tpugs/io/ply.py.

Per-vertex float32 properties, binary little-endian: x y z, nx ny nz
(zeros), f_dc_0..2, f_rest_0..3*(C-1)-1 (coefficient-major: for k in
1..C-1 emit ch0 ch1 ch2), opacity (logit), scale_0..2 (log), rot_0..3
(quat wxyz). Values stay in raw (pre-activation) parameter space.
"""
from __future__ import annotations

import numpy as np


def write_gaussian_ply(path, means, sh, opacity_logits, log_scales, quats):
    """means [N,3], sh [N,3,C], opacity_logits [N], log_scales [N,3],
    quats [N,4], through the native C++ writer
    (native/colmap_io.cpp::tpugs_write_gaussian_ply, data/native.py), as the
    reference's write_gaussian_ply; raises where the native library cannot
    be built or loaded. write_gaussian_ply_numpy writes the same bytes."""
    from tpugs_torch.data import native

    native.write_gaussian_ply(path, means, sh, opacity_logits, log_scales,
                              quats)


def write_gaussian_ply_numpy(path, means, sh, opacity_logits, log_scales,
                             quats):
    """means [N,3], sh [N,3,C], opacity_logits [N], log_scales [N,3],
    quats [N,4]."""
    means = np.asarray(means, np.float32)
    sh = np.asarray(sh, np.float32)
    op = np.asarray(opacity_logits, np.float32).reshape(-1, 1)
    scales = np.asarray(log_scales, np.float32)
    quats = np.asarray(quats, np.float32)
    n, _, c = sh.shape
    num_rest = 3 * (c - 1)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {p}" for p in ("x", "y", "z", "nx", "ny", "nz")]
    header += [f"property float f_dc_{i}" for i in range(3)]
    header += [f"property float f_rest_{i}" for i in range(num_rest)]
    header += ["property float opacity"]
    header += [f"property float scale_{i}" for i in range(3)]
    header += [f"property float rot_{i}" for i in range(4)]
    header += ["end_header"]

    dc = sh[:, :, 0]
    rest = np.transpose(sh[:, :, 1:], (0, 2, 1)).reshape(n, num_rest)
    row = np.concatenate(
        [means, np.zeros((n, 3), np.float32), dc, rest, op, scales, quats], axis=1
    ).astype("<f4")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(row.tobytes())


def read_gaussian_ply(path):
    """-> dict(means, sh [N,3,C], opacity_logits, log_scales, quats) numpy.

    Parses the header generically (property order may differ between
    writers); the SH degree follows from the f_rest count."""
    with open(path, "rb") as f:
        data = f.read()

    end = data.index(b"end_header")
    header = data[:end].decode("ascii").splitlines()
    body = data[data.index(b"\n", end) + 1:]

    n = None
    props = []
    fmt = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property":
            if parts[1] != "float":
                raise ValueError(f"unsupported property type {parts[1]}")
            props.append(parts[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    if n is None:
        raise ValueError("PLY header has no vertex element")

    arr = np.frombuffer(body, "<f4", count=n * len(props)).reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}

    num_rest = sum(1 for p in props if p.startswith("f_rest_"))
    c = num_rest // 3 + 1
    sh = np.zeros((n, 3, c), np.float32)
    for ch in range(3):
        sh[:, ch, 0] = arr[:, col[f"f_dc_{ch}"]]
    for k in range(1, c):
        for ch in range(3):
            sh[:, ch, k] = arr[:, col[f"f_rest_{(k - 1) * 3 + ch}"]]

    def take(names):
        return arr[:, [col[p] for p in names]].copy()

    return {
        "means": take(["x", "y", "z"]),
        "sh": sh,
        "opacity_logits": arr[:, col["opacity"]].copy(),
        "log_scales": take(["scale_0", "scale_1", "scale_2"]),
        "quats": take(["rot_0", "rot_1", "rot_2", "rot_3"]),
    }


def write_points_ply(path, points, colors=None):
    """Debug point-cloud PLY: float x y z per vertex, and uchar red green
    blue from colors in [0, 1] when given."""
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(pts.astype("<f4").tobytes())
        else:
            cols = np.asarray(np.clip(colors, 0, 1) * 255 + 0.5, np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
