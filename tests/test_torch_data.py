"""Parity of the port's dataset loaders, PLY reader, image I/O, Scene and
visualizations with the JAX package.

The fixture scenes are tests/test_data.py's (Blender RGBA, COLMAP text,
HyperNeRF) and a COLMAP binary one written here with struct; each package
loads its own copy of a fixture (a loader writes its point cloud's PLY
into the scene). Everything compared is numpy code or a decode, so it is
held equal bit for bit: the cameras' R, T, fov, time, size and names, the
points and colours, the images, the random 50k-point init, PLY bytes and
the camera order. The JAX package decodes through PIL here: its native
decoder multiplies each byte by 1/255 (one ulp off byte / 255 on 126 of
256 values), the port's and PIL divide, and the port's two decoders are
held equal to each other. The JAX package's lazy Blender camera keeps RGB
and drops the alpha; the port composites it as the eager load does, and
test_jax_lazy_blender_image_drops_alpha keeps that difference in view.
"""
import dataclasses
import json
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

from test_data import blender_dir, colmap_dir, hyper_dir  # noqa: F401
from torch_port_util import one_torch_thread  # noqa: F401

from gaussianprediction_tpu import config as jcfg
from gaussianprediction_tpu.data import blender as jblender
from gaussianprediction_tpu.data import colmap as jcolmap
from gaussianprediction_tpu.data import hypernerf as jhyper
from gaussianprediction_tpu.data import native as jnative
from gaussianprediction_tpu.data import scene as jscene
from gaussianprediction_tpu.eval import visualize as jvis
from gaussianprediction_tpu.utils import ply as jply
from gaussianprediction_tpu_torch import config as tcfg
from gaussianprediction_tpu_torch.data import blender as tblender
from gaussianprediction_tpu_torch.data import colmap as tcolmap
from gaussianprediction_tpu_torch.data import hypernerf as thyper
from gaussianprediction_tpu_torch.data import image_io as tio
from gaussianprediction_tpu_torch.data import native as tnative
from gaussianprediction_tpu_torch.data import scene as tscene
from gaussianprediction_tpu_torch.eval import visualize as tvis
from gaussianprediction_tpu_torch.utils import ply as tply


@pytest.fixture
def jax_pil(monkeypatch):
    """The JAX package's image decode through PIL (byte / 255)."""
    monkeypatch.setattr(jnative, "decode_png", lambda *a, **k: None)


def twins(src, tmp_path):
    """Two copies of a fixture scene: (the JAX package's, the port's)."""
    out = []
    for name in ("jax", "port"):
        dst = str(tmp_path / name)
        shutil.copytree(src, dst)
        out.append(dst)
    return out


def assert_cameras_equal(ours, ref, images=True):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for k in ("uid", "fovx", "fovy", "time", "width", "height",
                  "image_name"):
            assert getattr(a, k) == getattr(b, k), k
        for k in ("R", "T", "world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        assert os.path.basename(a.image_path) == \
            os.path.basename(b.image_path)
        if images:
            np.testing.assert_array_equal(a.load_image(), b.load_image())


def assert_infos_equal(ours, ref, images=True):
    np.testing.assert_array_equal(ours.points, ref.points)
    np.testing.assert_array_equal(ours.colors, ref.colors)
    assert ours.total_frame == ref.total_frame
    for split in ("train_cameras", "test_cameras", "render_cameras"):
        assert_cameras_equal(getattr(ours, split), getattr(ref, split),
                             images)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("max_time", [0.7, 1.0])
def test_blender_scene_info_equal(blender_dir, tmp_path, jax_pil, white,
                                  max_time):
    jdir, tdir = twins(blender_dir, tmp_path)
    ref = jblender.read_nerf_synthetic(jdir, white, eval_split=True,
                                       max_time=max_time)
    ours = tblender.read_nerf_synthetic(tdir, white, eval_split=True,
                                        max_time=max_time)
    assert_infos_equal(ours, ref)
    # the lazy port camera decodes to the eager image, bit for bit
    lazy = tblender.read_nerf_synthetic(tdir, white, eval_split=True,
                                        max_time=max_time, lazy=True)
    assert all(c.image is None for c in lazy.train_cameras)
    assert_infos_equal(lazy, ref)


def test_blender_random_init_equal(blender_dir, tmp_path):
    """No points3d.ply: both packages draw the 50k-point init from
    default_rng(0) in one order and write the same PLY bytes."""
    jdir, tdir = twins(blender_dir, tmp_path)
    ref = jblender.read_nerf_synthetic(jdir, False, eval_split=True,
                                       lazy=True)
    ours = tblender.read_nerf_synthetic(tdir, False, eval_split=True,
                                        lazy=True)
    assert ours.points.shape == (50_000, 3)
    np.testing.assert_array_equal(ours.points, ref.points)
    np.testing.assert_array_equal(ours.colors, ref.colors)
    with open(ref.ply_path, "rb") as a, open(ours.ply_path, "rb") as b:
        assert a.read() == b.read()


def test_jax_lazy_blender_image_drops_alpha(blender_dir, tmp_path, jax_pil):
    """The JAX package's lazy Blender camera decodes RGB and drops the
    alpha (its eager load composites); the port's lazy camera composites.
    They differ wherever the fixture is transparent."""
    jdir, tdir = twins(blender_dir, tmp_path)
    ref = jblender.read_nerf_synthetic(jdir, False, eval_split=True,
                                       lazy=True)
    ours = tblender.read_nerf_synthetic(tdir, False, eval_split=True,
                                        lazy=True)
    a, b = ours.train_cameras[0], ref.train_cameras[0]
    rgba = np.asarray(Image.open(a.image_path), np.float32) / 255.0
    diff = np.abs(a.load_image() - b.load_image()).max(-1)
    clear = rgba[..., 3] < 0.05
    assert clear.any() and diff[clear].min() > 0.0
    assert diff.max() > 0.9
    np.testing.assert_array_equal(a.load_image(),
                                  rgba[..., :3] * rgba[..., 3:4])


def write_colmap_binary(d, rng):
    """A COLMAP binary model (cameras.bin, images.bin, points3D.bin) of 5
    views of one PINHOLE camera, with its images."""
    sparse = d / "sparse" / "0"
    sparse.mkdir(parents=True)
    (d / "images").mkdir()
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 40, 30))
        f.write(struct.pack("<dddd", 50.0, 51.0, 20.0, 15.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 5))
        for i in range(5):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *rng.normal(size=3)))
            f.write(struct.pack("<i", 1))
            f.write(f"img_{i}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", i % 3))
            for _ in range(i % 3):
                f.write(struct.pack("<ddq", 1.0, 2.0, -1))
            Image.fromarray(rng.integers(0, 256, (30, 40, 3), np.uint8)
                            ).save(d / "images" / f"img_{i}.png")
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 12))
        for i in range(12):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *rng.normal(size=3)))
            f.write(struct.pack("<BBB", *rng.integers(0, 256, 3)))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, 0, 2, 1))


@pytest.mark.parametrize("kind", ["text", "binary"])
@pytest.mark.parametrize("lazy", [True, False])
def test_colmap_scene_info_equal(colmap_dir, tmp_path, jax_pil, kind, lazy):
    if kind == "binary":
        src = tmp_path / "colmap_bin"
        write_colmap_binary(src, np.random.default_rng(5))
        src = str(src)
    else:
        src = colmap_dir
    jdir, tdir = twins(src, tmp_path)
    ref = jcolmap.read_colmap_scene(jdir, llffhold=2, lazy=lazy)
    ours = tcolmap.read_colmap_scene(tdir, llffhold=2, lazy=lazy)
    assert len(ours.train_cameras) + len(ours.test_cameras) == \
        (4 if kind == "text" else 5)
    assert_infos_equal(ours, ref)
    with open(ref.ply_path, "rb") as a, open(ours.ply_path, "rb") as b:
        assert a.read() == b.read()


def test_colmap_readers_equal(tmp_path):
    write_colmap_binary(tmp_path / "c", np.random.default_rng(6))
    sparse = str(tmp_path / "c" / "sparse" / "0")
    for name in ("cameras", "images"):
        ours = getattr(tcolmap, f"read_{name}_binary")(
            os.path.join(sparse, f"{name}.bin"))
        ref = getattr(jcolmap, f"read_{name}_binary")(
            os.path.join(sparse, f"{name}.bin"))
        assert ours.keys() == ref.keys()
        for k in ours:
            for x, y in zip(ours[k], ref[k]):
                np.testing.assert_array_equal(x, y)
    for x, y in zip(tcolmap.read_points3d_binary(
            os.path.join(sparse, "points3D.bin")),
            jcolmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))):
        np.testing.assert_array_equal(x, y)
    q = np.random.default_rng(7).normal(size=4)
    np.testing.assert_array_equal(tcolmap.qvec2rotmat(q),
                                  jcolmap.qvec2rotmat(q))


@pytest.mark.parametrize("max_time", [1.0, 0.6])
@pytest.mark.parametrize("lazy", [True, False])
def test_hyper_scene_info_equal(hyper_dir, tmp_path, jax_pil, max_time,
                                lazy):
    jdir, tdir = twins(hyper_dir, tmp_path)
    ref = jhyper.read_hyper_scene(jdir, max_time=max_time, ratio=0.5,
                                  lazy=lazy)
    ours = thyper.read_hyper_scene(tdir, max_time=max_time, ratio=0.5,
                                   lazy=lazy)
    assert ours.train_cameras and ours.test_cameras
    assert_infos_equal(ours, ref)
    assert thyper.hyper_splits(tdir, max_time) == \
        jhyper.hyper_splits(jdir, max_time)


def test_load_scene_info_detects_each_format(blender_dir, colmap_dir,
                                             hyper_dir, tmp_path, jax_pil):
    for src, preset in ((blender_dir, "dnerf"), (colmap_dir, "test"),
                        (hyper_dir, "chickchicken")):
        jdir, tdir = twins(src, tmp_path / os.path.basename(src))
        jc, tc = jcfg.get_preset(preset), tcfg.get_preset(preset)
        jc.source_path, tc.source_path = jdir, tdir
        jc.model.max_time = tc.model.max_time = 0.8
        # (images: the JAX package's lazy Blender camera drops the alpha)
        assert_infos_equal(tscene.load_scene_info(tc, lazy=True),
                           jscene.load_scene_info(jc, lazy=True),
                           images=False)
    tc.source_path = str(tmp_path)
    with pytest.raises(ValueError, match="Could not recognize"):
        tscene.load_scene_info(tc)


@pytest.mark.parametrize("prefetch", [0, 4])
def test_scene_sampling_equal(blender_dir, tmp_path, prefetch):
    """The camera sequence over 3.5 epochs is JAX's, with and without the
    decode-ahead; with it, a drawn camera's decode has finished."""
    jdir, tdir = twins(blender_dir, tmp_path)
    ref = jscene.Scene(jblender.read_nerf_synthetic(
        jdir, False, eval_split=False, lazy=True), seed=3, prefetch=0)
    ours = tscene.Scene(tblender.read_nerf_synthetic(
        tdir, False, eval_split=False, lazy=True), seed=3,
        prefetch=prefetch)
    n = len(ours.train_cameras)
    got, want = [], []
    for _ in range(n * 7 // 2):
        cam = ours.next_train_camera()
        got.append(cam.uid)
        want.append(ref.next_train_camera().uid)
        if prefetch and ours.decode_stats["draws"] > 1:
            assert cam.image is not None
        cam.load_image()
    ours.close()
    assert got == want
    st = ours.decode_stats
    assert st["draws"] == len(got) and st["waited"] <= n


def test_ply_roundtrip_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(37, 3)).astype(np.float32)
    rgb = rng.uniform(0, 300, (37, 3))
    tply.store_point_cloud(str(tmp_path / "t.ply"), xyz, rgb)
    jply.store_point_cloud(str(tmp_path / "j.ply"), xyz, rgb)
    with open(tmp_path / "t.ply", "rb") as a, \
            open(tmp_path / "j.ply", "rb") as b:
        assert a.read() == b.read()
    for a, b in zip(tply.fetch_point_cloud(str(tmp_path / "j.ply")),
                    jply.fetch_point_cloud(str(tmp_path / "t.ply"))):
        np.testing.assert_array_equal(a, b)
    # ascii, float colours, no normals
    with open(tmp_path / "a.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                "property float y\nproperty float z\nproperty float red\n"
                "property float green\nproperty float blue\nend_header\n")
        for p in rng.uniform(0, 1, (3, 6)):
            f.write(" ".join(f"{v:.6f}" for v in p) + "\n")
    ours, ref = tply.read_ply(str(tmp_path / "a.ply")), \
        jply.read_ply(str(tmp_path / "a.ply"))
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    for a, b in zip(tply.fetch_point_cloud(str(tmp_path / "a.ply")),
                    jply.fetch_point_cloud(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(a, b)


def test_visualize_plys_equal(tmp_path):
    """The inputs of tests/test_eval.py::TestVisualize through both."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    feats = rng.normal(size=(50, 8)).astype(np.float32)
    nn_idx = rng.integers(0, 4, (50, 3)).astype(np.int32)
    w = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    traj = rng.normal(size=(6, 5, 3)).astype(np.float32)
    out = {}
    for name, V in (("jax", jvis), ("port", tvis)):
        d = tmp_path / name
        d.mkdir()
        rgb = V.pca_vis(xyz, feats, str(d / "pca.ply"))
        V.feature_vis(xyz, feats, str(d / "feat.ply"))
        V.weights_vis(xyz, w, nn_idx, kpt_index=2,
                      output_path=str(d / "w.ply"))
        V.trajectory_vis(traj, str(d / "traj.ply"))
        out[name] = rgb
    np.testing.assert_array_equal(out["port"], out["jax"])
    for f in ("pca.ply", "feat.ply", "w.ply", "traj.ply"):
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    pts, cols, _ = tply.fetch_point_cloud(str(tmp_path / "port" /
                                              "traj.ply"))
    assert pts.shape == (40, 3) and np.all(cols[-10:] == 0.0)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_native_decoder_equals_pil(tmp_path, mode):
    """The port's native decoder and PIL give byte / 255 as float32 bit for
    bit, in both channel counts (its build needs g++ and zlib, as here)."""
    assert tnative.available(), tnative.build_error
    rng = np.random.default_rng(1)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    arr = rng.integers(0, 256, (19, 23, c), np.uint8)
    arr[0, :, :] = np.arange(23)[:, None] * 11       # every filter's edge
    img = Image.fromarray(arr[..., 0] if c == 1 else arr,
                          mode if mode != "P" else "L")
    if mode == "P":
        img = img.convert("P")
    p = str(tmp_path / f"{mode}.png")
    img.save(p)
    for channels in (3, 4):
        nat = tnative.decode_png(p, channels=channels)
        conv = "RGBA" if channels == 4 else "RGB"
        pil = np.asarray(Image.open(p).convert(conv), np.float32) / 255.0
        assert nat is not None and nat.dtype == np.float32
        np.testing.assert_array_equal(nat, pil)
    rgb = tio.load_image(p)
    np.testing.assert_array_equal(rgb, tnative.decode_png(p, channels=3))
    assert tio.image_size(p) == (23, 19)
    assert tnative.decode_png(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_write_png_reads_back(tmp_path, c):
    arr = np.random.default_rng(c).integers(0, 256, (17, 29, c), np.uint8)
    p = str(tmp_path / "w.png")
    tio.write_png(p, arr)
    back = np.asarray(Image.open(p))
    np.testing.assert_array_equal(back.reshape(arr.shape), arr)
    out = tio.load_image_rgba(p)
    want = arr.astype(np.float32) / 255.0
    if c <= 2:
        want = np.concatenate([want[..., :1]] * 3 + (
            [want[..., 1:]] if c == 2 else [np.ones_like(want[..., :1])]),
            -1)
    elif c == 3:
        want = np.concatenate([want, np.ones_like(want[..., :1])], -1)
    np.testing.assert_array_equal(out, want)


def test_write_nerf_synthetic_reads_back(tmp_path):
    """write_nerf_synthetic's tree loads in both packages; the images are
    the written bytes / 255 with the black pixels transparent."""
    from gaussianprediction_tpu_torch.data.synthetic import orbit_camera

    rng = np.random.default_rng(2)
    cams = []
    for i in range(4):
        c = orbit_camera(0.3 * i, width=12, height=10, time=i / 3.0, uid=i)
        img = rng.uniform(0, 1, (10, 12, 3)).astype(np.float32)
        img[:3] = 0.0
        cams.append(dataclasses.replace(c, image=img))
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    tblender.write_nerf_synthetic(str(tmp_path / "s"), cams, pts,
                                  rng.uniform(0, 1, (9, 3)))
    for white in (False, True):
        info = tblender.read_nerf_synthetic(str(tmp_path / "s"), white,
                                            eval_split=True, max_time=0.5,
                                            lazy=True)
        assert [c.time for c in info.train_cameras] == [0.0, 1 / 3.0]
        assert len(info.test_cameras) == 2
        for src, cam in zip(cams, info.train_cameras + info.test_cameras):
            u8 = (src.image * 255).astype(np.uint8).astype(np.float32)
            a = np.where((src.image == 0).all(-1), 0.0, 1.0)[..., None]
            a = a.astype(np.float32)
            want = (u8 / 255.0) * a + float(white) * (1.0 - a)
            np.testing.assert_array_equal(cam.load_image(), want)
            np.testing.assert_allclose(cam.R, src.R, atol=1e-6)
            np.testing.assert_allclose(cam.T, src.T, atol=1e-5)
        np.testing.assert_array_equal(info.points, pts)
    ref = jblender.read_nerf_synthetic(str(tmp_path / "s"), False,
                                       eval_split=True, max_time=0.5)
    assert_infos_equal(
        tblender.read_nerf_synthetic(str(tmp_path / "s"), False,
                                     eval_split=True, max_time=0.5), ref,
        images=False)
    with open(tmp_path / "s" / "transforms_train.json") as f:
        assert len(json.load(f)["frames"]) == 4


def test_write_hypernerf_reads_back(tmp_path, jax_pil):
    """write_hypernerf's tree loads in both packages alike: the
    every-4th-frame split, each frame's time its index / (n - 1), the
    images the written bytes / 255, the poses and fields of view those
    written (within the Nerfies camera's f32 rounding)."""
    from gaussianprediction_tpu_torch.data.synthetic import orbit_camera

    rng = np.random.default_rng(3)
    cams = []
    for i in range(10):
        c = orbit_camera(0.3 * i, width=24, height=14, time=i / 9.0, uid=i)
        img = rng.uniform(0, 1, (14, 24, 3)).astype(np.float32)
        cams.append(dataclasses.replace(c, image=img))
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    path = str(tmp_path / "h")
    thyper.write_hypernerf(path, cams, pts, rng.uniform(0, 1, (9, 3)))
    ours = thyper.read_hyper_scene(path, ratio=0.5)
    assert [c.image_name for c in ours.train_cameras] == \
        ["000000", "000004", "000008"]
    assert [c.image_name for c in ours.test_cameras] == ["000002", "000006"]
    for cam in ours.train_cameras + ours.test_cameras:
        src = cams[int(cam.image_name)]
        assert cam.time == src.time and (cam.width, cam.height) == (24, 14)
        u8 = (src.image * 255).astype(np.uint8).astype(np.float32)
        np.testing.assert_array_equal(cam.load_image(), u8 / 255.0)
        np.testing.assert_allclose(cam.R, src.R, atol=1e-6)
        np.testing.assert_allclose(cam.T, src.T, atol=1e-5)
        assert cam.fovx == pytest.approx(src.fovx, rel=1e-6)
        assert cam.fovy == pytest.approx(src.fovy, rel=1e-6)
    np.testing.assert_array_equal(ours.points, pts)
    assert_infos_equal(ours, jhyper.read_hyper_scene(path, ratio=0.5))
