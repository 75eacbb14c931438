"""The benchmark scene presets (counterpart of
``ceres_tpu/render/scenes.py``): the camera, sun and mesh rotation of the
scenes the C++ reference fixtures were rendered from
(``tests/fixtures/bunny_64_smooth_ref.ppm``,
``dragon_64_static_ref.ppm``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ceres_tpu_torch.io.obj import load_obj
from ceres_tpu_torch.models.camera import Camera
from ceres_tpu_torch.models.transform import rotate_vertices_about_axis

AXES = {"x": 0, "y": 1, "z": 2}


def data_dir() -> str:
    """The repository's ``data/`` directory (bunny and dragon meshes)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data")


DATA_DIR = data_dir()


def bunny_path() -> str:
    return os.path.join(data_dir(), "bunny.obj")


def dragon_path() -> str:
    return os.path.join(data_dir(), "dragon.obj")


@dataclasses.dataclass
class Scene:
    vertices: np.ndarray
    faces: np.ndarray
    camera: Camera
    sun: np.ndarray
    name: str = "scene"


def load_scene(obj_path: str, eye=(0.0, 0.1, -0.3),
               direction: Optional[tuple] = None, up=(0.0, 1.0, 0.0),
               fov: float = 60.0, sun=(-50.0, 100.0, 0.0),
               rotate_axis: Optional[str] = None, rotate_degrees: float = 0.0,
               name: str = "scene") -> Scene:
    """An OBJ mesh, optionally rotated about a coordinate axis, with a
    camera at ``eye`` looking along ``direction`` (default: at the mesh
    centroid) and the sun. Vertices and faces are numpy arrays; the camera
    is on the CPU."""
    vertices, faces = load_obj(obj_path)
    if rotate_axis is not None and rotate_degrees != 0.0:
        vertices = rotate_vertices_about_axis(
            vertices, AXES[rotate_axis], rotate_degrees).numpy()
    if direction is None:
        center = vertices.mean(axis=0)
        direction = tuple(center - np.asarray(eye, np.float32))
    camera = Camera.make(eye=eye, dir=direction, up=up, fov=fov)
    return Scene(vertices=vertices, faces=faces, camera=camera,
                 sun=np.asarray(sun, np.float32), name=name)


def bunny_scene(rotate_degrees: float = -145.0) -> Scene:
    """The bunny preset: eye (0, .1, -.3), up y, fov 60, sun (-50, 100, 0),
    mesh rotated about y."""
    return load_scene(bunny_path(),
                      eye=(0.0, 0.1, -0.3), up=(0.0, 1.0, 0.0), fov=60.0,
                      sun=(-50.0, 100.0, 0.0), rotate_axis="y",
                      rotate_degrees=rotate_degrees, name="bunny")


def dragon_scene() -> Scene:
    """The reference's static preset: dragon rotated 90 degrees about x,
    eye (0, -15, 2), direction (0, 1, 0), up z, fov 60, sun (-50, -20,
    0)."""
    return load_scene(dragon_path(),
                      eye=(0.0, -15.0, 2.0), direction=(0.0, 1.0, 0.0),
                      up=(0.0, 0.0, 1.0), fov=60.0, sun=(-50.0, -20.0, 0.0),
                      rotate_axis="x", rotate_degrees=90.0, name="dragon")
