"""Software multi-view renderer for OBJ shapes (offline preprocessing).

The port's copy of ``tricolo_tpu.data.render``, the same constants, the
same z-buffer and the same uint8 output: ``num_views`` 224×224 views per
ShapeNet OBJ, a perspective camera (yfov π/3, aspect 1) on a ring of yaw
angles about +y, tilted by elevation π/5, looking at the mesh centroid
from distance 0.85; one directional light shining along −y (from above)
with intensity 3.0 plus ambient 0.1; lambertian shading of a neutral albedo
(MTL files are not parsed). A vectorized numpy rasterizer on the host:
rendering is offline and runs on no device. ``load_obj`` is also what the
mesh F1 (``evaluation/f1_mesh.py``) parses meshes with.
"""

from __future__ import annotations

import os

import numpy as np

IMAGE_SIZE = 224
YFOV = np.pi / 3
ELEVATION = np.pi / 5
DISTANCE = 0.85
AMBIENT = 0.1
LIGHT_INTENSITY = 3.0
LIGHT_DIRECTION = np.array([0.0, -1.0, 0.0])  # from above, see module docstring
ALBEDO = np.array([0.75, 0.75, 0.75])
BACKGROUND = np.array([255, 255, 255], dtype=np.uint8)


def load_obj(path: str):
    """Minimal OBJ parser → (vertices (V,3) float64, faces (F,3) int32).

    Handles v/f statements; polygon faces fan-triangulate; v/vt/vn index
    forms and negative indices are supported. Materials are ignored.
    """
    vertices: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    raw = int(token.split("/")[0])
                    idx.append(raw - 1 if raw > 0 else len(vertices) + raw)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not vertices or not faces:
        raise ValueError(f"{path}: no renderable geometry")
    return np.asarray(vertices, np.float64), np.asarray(faces, np.int32)


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix (3×3)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    k_cross = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(angle) * k_cross + (1 - np.cos(angle)) * (k_cross @ k_cross)


def camera_pose(centroid: np.ndarray, yaw: float) -> np.ndarray:
    """4×4 camera-to-world pose on the reference's view ring.

    Matches trimesh.scene.cameras.look_at(points=centroid, fov=π/3,
    distance=0.85, rotation=R_y(yaw)·R_{−x}(π/5)) as used at
    preprocess_all_data.py:71-78: the camera sits ``distance`` along the
    rotated +z axis from the centroid, oriented by the composed rotation
    (OpenGL convention: camera looks along −z).
    """
    rot = _rotation([0, 1, 0], yaw) @ _rotation([-1, 0, 0], ELEVATION)
    pose = np.eye(4)
    pose[:3, :3] = rot
    pose[:3, 3] = centroid + rot @ np.array([0.0, 0.0, DISTANCE])
    return pose


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    pose: np.ndarray,
    image_size: int = IMAGE_SIZE,
) -> np.ndarray:
    """Rasterize one view → (H, W, 3) uint8 with a z-buffer.

    Vectorized over faces: project vertices, compute per-face screen bboxes,
    then scanline-fill each face's bbox with barycentric tests. Lambertian
    shading with two-sided face normals, directional + ambient light.
    """
    # World → camera (inverse of camera-to-world pose).
    rot = pose[:3, :3].T
    trans = -rot @ pose[:3, 3]
    cam = vertices @ rot.T + trans

    focal = 1.0 / np.tan(YFOV / 2)
    # Perspective: x_ndc = f·x/−z, y_ndc = f·y/−z (camera looks along −z).
    z = cam[:, 2]
    valid_depth = z < -1e-6
    with np.errstate(divide="ignore", invalid="ignore"):
        x_ndc = focal * cam[:, 0] / -z
        y_ndc = focal * cam[:, 1] / -z
    px = (x_ndc * 0.5 + 0.5) * (image_size - 1)
    py = (1.0 - (y_ndc * 0.5 + 0.5)) * (image_size - 1)

    # Face normals (world space) for shading.
    tri = vertices[faces]  # (F, 3, 3)
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm_len = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norm_len, 1e-12)
    lambert = np.abs(normals @ -LIGHT_DIRECTION)  # two-sided
    shade = np.clip(AMBIENT + LIGHT_INTENSITY / np.pi * lambert, 0.0, 1.0)
    face_rgb = (shade[:, None] * ALBEDO[None, :] * 255).astype(np.uint8)

    color = np.broadcast_to(BACKGROUND, (image_size, image_size, 3)).copy()
    # Store 1/(-z) (more = closer): screen-space barycentrics interpolate
    # 1/z linearly, not z — affine z interpolation resolves visibility
    # wrong where large triangles spanning a deep z range overlap nearer
    # geometry (perspective correction).
    zbuf = np.full((image_size, image_size), -np.inf)

    fx = px[faces]  # (F, 3)
    fy = py[faces]
    fz = z[faces]
    face_ok = valid_depth[faces].all(axis=1) & (norm_len[:, 0] > 1e-12)

    for f_idx in np.nonzero(face_ok)[0]:
        xs, ys, zs = fx[f_idx], fy[f_idx], fz[f_idx]
        min_x = max(int(np.floor(xs.min())), 0)
        max_x = min(int(np.ceil(xs.max())), image_size - 1)
        min_y = max(int(np.floor(ys.min())), 0)
        max_y = min(int(np.ceil(ys.max())), image_size - 1)
        if min_x > max_x or min_y > max_y:
            continue
        gx, gy = np.meshgrid(
            np.arange(min_x, max_x + 1), np.arange(min_y, max_y + 1)
        )
        # Barycentric coordinates on screen.
        d = (ys[1] - ys[2]) * (xs[0] - xs[2]) + (xs[2] - xs[1]) * (ys[0] - ys[2])
        if abs(d) < 1e-12:
            continue
        w0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / d
        w1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        depth = w0 / -zs[0] + w1 / -zs[1] + w2 / -zs[2]  # interpolated 1/(-z)
        region_z = zbuf[min_y : max_y + 1, min_x : max_x + 1]
        update = inside & (depth > region_z)
        region_z[update] = depth[update]
        color[min_y : max_y + 1, min_x : max_x + 1][update] = face_rgb[f_idx]

    return color


def render_views(
    obj_path: str,
    num_views: int,
    image_size: int = IMAGE_SIZE,
) -> np.ndarray:
    """Render the reference's yaw ring → (num_views, H, W, 3) uint8."""
    vertices, faces = load_obj(obj_path)
    centroid = vertices.mean(axis=0)
    angles = np.linspace(0, 2 * np.pi, num_views, endpoint=False)
    return np.stack(
        [render_mesh(vertices, faces, camera_pose(centroid, a), image_size) for a in angles]
    )


def render_one_obj(
    category_model_id: tuple,
    obj_model_root_path: str,
    output_root_path: str,
    num_views: int,
):
    """Per-model render job (reference render_one_obj contract): writes
    ``{output_root}/{category}/{model_id}/{i}.jpg``."""
    from PIL import Image

    category, model_id = category_model_id
    obj_path = os.path.join(
        obj_model_root_path, category, model_id, "models", "model_normalized.obj"
    )
    out_dir = os.path.join(output_root_path, category, model_id)
    os.makedirs(out_dir, exist_ok=True)
    views = render_views(obj_path, num_views)
    for i, view in enumerate(views):
        Image.fromarray(view).save(os.path.join(out_dir, f"{i}.jpg"))
