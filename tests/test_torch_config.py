"""The port's OpenCV-YAML loaders, dataset writer and CLI input against the
JAX package's, on the same files.

- `load_slam_settings`, `load_rig_calibration` and `load_intrinsics` equal
  JAX's exactly on the three files `write_calibration_yamls` writes and on
  hand-written files with OpenCV's quirks; `load_opencv_yaml` equals JAX's
  pyyaml dict on every scalar form both read alike (pyyaml's YAML 1.1 reads
  `1e-05` as a string, which the loaders float(); the port reads a float).
- `load_rig(device="cpu")` equals the JAX rig carried over by
  `convert.rig_from_numpy`, bit for bit in float32.
- The port's `write_dataset` of its world and JAX's of JAX's world (the
  same `make_world` arguments) write byte-identical directories.
- `load_image_list` and `load_gray` (P5, P6, a header comment, 16 bits, and
  a PNG through imageio) equal JAX's.
"""
import builtins
import os

import numpy as np
import pytest

from multicol_slam_tpu import cli as jcli
from multicol_slam_tpu.io.render import write_dataset as jwrite_dataset
from multicol_slam_tpu.io.synthetic import make_world as jmake_world
from multicol_slam_tpu.utils import config as jconfig
from multicol_slam_tpu_torch import cli as tcli
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.io.render import write_dataset
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.utils import config as tconfig

WORLD = dict(n_points=200, n_frames=3, n_cams=3, n_feats=50, noise_px=0.0, trajectory="line", seed=7)

QUIRKS_SETTINGS = """%YAML:1.0
---
# the extractor block, OpenCV style

Camera.fps:30.0
Camera.RGB: 1   # a trailing comment
Camera.name: "fisheye #1"
Camera.label: 'left'
extractor.usemdBRIEF:0
extractor.masks: 0
extractor.nFeatures:  800
extractor.scaleFactor: 1.25
extractor.nLevels: 0x8
extractor.fastTh: +20
extractor.descSize: 32
UseMotionModel: 0
traj.StartFrame: 0
traj.EndFrame: -1
"""

QUIRKS_INTRINSICS = """%YAML:1.0
Camera.Iw:754
Camera.Ih: 480
Camera.nrpol: 5
Camera.nrinvpol: 3
Camera.a0: -2.092e+02
Camera.a1: 0
Camera.a2: 1e-05
Camera.a3: -4.2E-06
Camera.a4: .5
Camera.pol0: 293.7
Camera.pol1:150.
Camera.pol2: -10.4
Camera.c: 1.0
Camera.d: 0.
Camera.e: -0.0
Camera.u0: 377.0
Camera.v0: 240.5
Camera.mirrorMask: 0
"""

MATRIX_BLOCK = """Camera.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 1., 0., 0., 0., 1., 0., 0., 0., 1. ]
"""


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_ds"))
    jwrite_dataset(jmake_world(**WORLD), d)
    return d


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_ds"))
    write_dataset(make_world(**WORLD), d)
    return d


def _schemas(d):
    return [os.path.join(d, n) for n in ("Slam_Settings_synthetic.yaml", "MultiCamSys_Calibration.yaml",
                                         "InteriorOrientationFisheye0.yaml", "InteriorOrientationFisheye2.yaml")]


def _same_dicts(t, j):
    """Equal on every key; a value pyyaml left as a numeric string is the
    port's float."""
    assert set(t) == set(j)
    for k in j:
        if isinstance(j[k], str) and isinstance(t[k], float):
            assert float(j[k]) == t[k], k
        else:
            assert t[k] == j[k] and type(t[k]) is type(j[k]), (k, t[k], j[k])


def test_written_dataset_is_byte_identical(jax_dir, port_dir):
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert len([n for n in names if n.endswith(".pgm")]) == 3 * WORLD["n_frames"]
    for n in names:
        with open(os.path.join(jax_dir, n), "rb") as a, open(os.path.join(port_dir, n), "rb") as b:
            assert a.read() == b.read(), n


@pytest.mark.parametrize("i", range(4), ids=["settings", "rig", "cam0", "cam2"])
def test_raw_dicts_of_the_written_schemas(jax_dir, i):
    path = _schemas(jax_dir)[i]
    _same_dicts(tconfig.load_opencv_yaml(path), jconfig.load_opencv_yaml(path))


def test_loaders_on_the_written_schemas(jax_dir):
    s, r, c0, c2 = _schemas(jax_dir)
    assert tconfig.load_slam_settings(s).__dict__.keys() == jconfig.load_slam_settings(s).__dict__.keys()
    ts, js = tconfig.load_slam_settings(s), jconfig.load_slam_settings(s)
    assert (ts.fps, ts.rgb, ts.use_motion_model, ts.traj_start_frame, ts.traj_end_frame) == \
        (js.fps, js.rgb, js.use_motion_model, js.traj_start_frame, js.traj_end_frame)
    assert vars(ts.extractor) == vars(js.extractor)
    np.testing.assert_array_equal(tconfig.load_rig_calibration(r), jconfig.load_rig_calibration(r))
    for c in (c0, c2):
        assert vars(tconfig.load_intrinsics(c)) == vars(jconfig.load_intrinsics(c))


@pytest.mark.parametrize("text", [QUIRKS_SETTINGS, QUIRKS_INTRINSICS], ids=["settings", "intrinsics"])
def test_opencv_quirks(tmp_path, text):
    """The directive, `---`, `key:value` with no space, comments, blank
    lines, quoted strings, and the number forms, read alike."""
    path = tmp_path / "q.yaml"
    path.write_text(text)
    _same_dicts(tconfig.load_opencv_yaml(str(path)), jconfig.load_opencv_yaml(str(path)))
    if "Camera.Iw" in text:
        assert vars(tconfig.load_intrinsics(str(path))) == vars(jconfig.load_intrinsics(str(path)))
        assert tconfig.load_opencv_yaml(str(path))["Camera.a2"] == 1e-05   # pyyaml: the string '1e-05'
    else:
        ts, js = tconfig.load_slam_settings(str(path)), jconfig.load_slam_settings(str(path))
        assert vars(ts.extractor) == vars(js.extractor) and ts.fps == js.fps == 30.0
        assert ts.use_motion_model is js.use_motion_model is False
        assert tconfig.load_opencv_yaml(str(path))["Camera.name"] == "fisheye #1"


def test_matrix_block_is_skipped(tmp_path):
    """An OpenCV matrix (which pyyaml's safe loader refuses) is skipped,
    and every other key reads as without it."""
    plain, with_block = tmp_path / "a.yaml", tmp_path / "b.yaml"
    plain.write_text(QUIRKS_INTRINSICS)
    lines = QUIRKS_INTRINSICS.splitlines(keepends=True)
    with_block.write_text("".join(lines[:5]) + MATRIX_BLOCK + "".join(lines[5:]))
    assert tconfig.load_opencv_yaml(str(with_block)) == tconfig.load_opencv_yaml(str(plain))
    assert vars(tconfig.load_intrinsics(str(with_block))) == vars(jconfig.load_intrinsics(str(plain)))


@pytest.mark.parametrize("text,value", [("1", 1), ("-3", -3), ("0x1F", 31), ("017", 15), ("1_000", 1000),
                                        ("2.5", 2.5), ("-.5", -0.5), ("1.5e+3", 1500.0), (".inf", float("inf")),
                                        ("true", True), ("Off", False), ("~", None), ("'a # b'", "a # b"),
                                        ("abc", "abc"), ("1e-05", 1e-05)])
def test_scalar_forms(tmp_path, text, value):
    """Each scalar as pyyaml resolves it (the last: as float() reads it)."""
    assert tconfig.parse_scalar(text) == value and type(tconfig.parse_scalar(text)) is type(value)
    path = tmp_path / "s.yaml"
    path.write_text(f"key: {text}\n")
    j = jconfig.load_opencv_yaml(str(path))["key"]
    assert j == value or float(j) == value


def test_load_rig_equals_the_reference_rig(jax_dir):
    t = tconfig.load_rig(jax_dir, device="cpu")
    j = jconfig.load_rig(jax_dir)
    ref = convert.rig_from_numpy(*(np.asarray(getattr(j.cams, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                 np.asarray(j.Mc_cayley), device="cpu")
    for k in ("pol", "invpol", "cde", "pp", "wh"):
        a, b = getattr(t.cams, k), getattr(ref.cams, k)
        assert a.dtype == b.dtype and a.device.type == "cpu" and bool((a == b).all()), k
    assert t.Mc_cayley.dtype == ref.Mc_cayley.dtype and bool((t.Mc_cayley == ref.Mc_cayley).all())
    assert bool((t.Mc == ref.Mc).all())
    assert tconfig.load_rig(jax_dir, n_cams=2, device="cpu").n_cams == 2


def test_load_rig_defaults_to_the_card(jax_dir):
    import inspect

    import torch

    assert inspect.signature(tconfig.load_rig).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconfig.load_rig(jax_dir)


@pytest.mark.parametrize("start,end", [(1, 4), (0, -1), (2, 3), (3, 0), (5, -1)])
def test_load_image_list(tmp_path, start, end):
    lines = ["0.000000 a0.pgm a1.pgm a2.pgm", "0.040000 b0.pgm b1.pgm b2.pgm",
             "0.080000 c0.pgm c1.pgm c2.pgm", "0.120000 d0.pgm d1.pgm", "0.160000 e0.pgm e1.pgm e2.pgm"]
    (tmp_path / "images_and_timestamps.txt").write_text("\n".join(lines) + "\n")
    assert tcli.load_image_list(str(tmp_path), start, end) == jcli.load_image_list(str(tmp_path), start, end)


def _image_files(d, rng):
    g = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    rgb = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (5, 6), dtype=np.uint16)
    files = {
        "p5": (b"P5\n9 7\n255\n", g.tobytes()),
        "p5 comment": (b"P5\n# made by a test\n9 7\n255\n", g.tobytes()),
        "p6": (b"P6\n9 7\n255\n", rgb.tobytes()),
        "p5 16 bits": (b"P5\n6 5\n65535\n", g16.astype(">u2").tobytes()),
    }
    out = {}
    for name, (head, body) in files.items():
        path = os.path.join(d, name.replace(" ", "_") + (".ppm" if name == "p6" else ".pgm"))
        with open(path, "wb") as f:
            f.write(head + body)
        out[name] = path
    return out


@pytest.mark.parametrize("name", ["p5", "p5 comment", "p6", "p5 16 bits", "png"])
def test_load_gray(tmp_path, name):
    rng = np.random.default_rng(3)
    files = _image_files(str(tmp_path), rng)
    if name == "png":
        import imageio.v3 as iio

        files["png"] = str(tmp_path / "c.png")
        iio.imwrite(files["png"], rng.integers(0, 256, (7, 9, 3), dtype=np.uint8))
    t, j = tcli.load_gray(files[name]), jcli.load_gray(files[name])
    # a 16-bit PGM: the port keeps the file's uint16; imageio's pillow
    # plugin widens it to int32 (the values are the same)
    assert t.dtype == (np.uint16 if "16" in name else j.dtype) and t.shape == j.shape and t.ndim == 2
    np.testing.assert_array_equal(t, j)


def test_load_gray_names_the_file_without_a_reader(tmp_path, monkeypatch):
    """A format other than PGM/PPM goes to imageio or pillow; with neither,
    the error names the file."""
    path = tmp_path / "c.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n")
    real = builtins.__import__

    def no_readers(name, *a, **kw):
        if name.split(".")[0] in ("imageio", "PIL"):
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_readers)
    with pytest.raises(RuntimeError, match="c.png"):
        tcli.load_gray(str(path))
