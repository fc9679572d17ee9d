"""Parity of the port's data-format converters with the JAX package's, on
the CPU: ECD ``events.txt`` IO and ``txt_to_h5`` (with ``images.txt``),
``h5_to_memmap``, ``memmap_to_h5``, ``add_attribute``, the rosbag writer
fed message dicts (and its error without ROS), and every converter's
``main``. Each file a port converter writes is read by both packages'
readers, and what they read must be equal to what the JAX converter's
file reads as; the converters are host-side numpy, so equal means
bit-identical.
"""

import gzip
import json
import os

import numpy as np
import pytest

import event_utils_tpu.data_formats as JD
import event_utils_tpu_torch.data_formats as PD
from event_utils_tpu.errors import DataFormatError as JFormat
from event_utils_tpu_torch.errors import DataFormatError, DataNotFoundError


def stream(rng, n=900, sensor=(24, 32)):
    H, W = sensor
    xs = rng.integers(0, W, n).astype(np.int64)
    ys = rng.integers(0, H, n).astype(np.int64)
    ts = np.sort(rng.uniform(0, 1.0, n)).round(9)
    ps = rng.choice(np.array([-1.0, 1.0]), n)
    return xs, ys, ts, ps


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "path":
                continue
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_tree_equal(u, v)
    elif isinstance(a, (np.ndarray, np.generic)) or hasattr(a, "shape"):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


def read_h5_both(path):
    """The HDF5 as both packages read it; asserts the two agree."""
    j = JD.read_h5_events_dict(path)
    p = PD.read_h5_events_dict(path)
    assert_tree_equal(p, j)
    return p


def read_memmap_both(path):
    j = JD.read_memmap_events(path, return_events=True)
    p = PD.read_memmap_events(path, return_events=True)
    assert_tree_equal({k: v for k, v in p.items() if k != "path"},
                      {k: v for k, v in j.items() if k != "path"})
    return p


def test_txt_round_trip_both_ways(rng, tmp_path):
    xs, ys, ts, ps = stream(rng)
    for writer, name in ((PD.write_txt_events, "port.txt"),
                         (JD.write_txt_events, "jax.txt")):
        writer(str(tmp_path / name), xs, ys, ts, ps)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    got = PD.read_txt_events(str(tmp_path / "port.txt"))
    want = JD.read_txt_events(str(tmp_path / "port.txt"))
    assert_tree_equal(got, want)
    np.testing.assert_array_equal(got[0], xs)
    assert got[0].dtype == np.int64
    np.testing.assert_allclose(got[2], ts, atol=1e-9)
    np.testing.assert_array_equal(got[3], ps)


def test_txt_gz_chunked_and_errors(rng, tmp_path):
    xs, ys, ts, ps = stream(rng, n=700)
    plain = str(tmp_path / "events.txt")
    PD.write_txt_events(plain, xs, ys, ts, ps)
    gz = str(tmp_path / "events.txt.gz")
    with open(plain, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    assert_tree_equal(PD.read_txt_events(gz, chunk_rows=100),
                      JD.read_txt_events(gz, chunk_rows=100))
    bad = tmp_path / "bad.txt"
    bad.write_text("0.1 3 4 1\n0.2 five 4 0\n")
    with pytest.raises(DataFormatError):
        PD.read_txt_events(str(bad))
    with pytest.raises(JFormat):
        JD.read_txt_events(str(bad))
    with pytest.raises(DataNotFoundError):
        PD.read_txt_events(str(tmp_path / "missing.txt"))
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert_tree_equal(PD.read_txt_events(str(empty)),
                      JD.read_txt_events(str(empty)))


def images_txt(rng, tmp_path, ts, sensor=(24, 32)):
    import cv2
    lines = []
    for k, t in enumerate(np.linspace(ts[0], ts[-1], 4)):
        name = f"frame_{k:04d}.png"
        cv2.imwrite(str(tmp_path / name),
                    rng.integers(0, 255, sensor, np.uint8))
        lines.append(f"{t:.9f} {name}")
    lines.insert(1, "# a comment")
    (tmp_path / "images.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "images.txt")


@pytest.mark.parametrize("zero", [False, True])
def test_txt_to_h5_with_frames(rng, tmp_path, zero):
    xs, ys, ts, ps = stream(rng, n=800)
    ts = ts + 10.0
    evp = str(tmp_path / "events.txt")
    PD.write_txt_events(evp, xs, ys, ts, ps)
    imgs = images_txt(rng, tmp_path, ts)
    assert_tree_equal(PD.read_images_txt(imgs), JD.read_images_txt(imgs))
    outs = {}
    for pkg, name in ((PD, "port"), (JD, "jax")):
        outs[name] = str(tmp_path / f"{name}.h5")
        pkg.txt_to_h5(evp, outs[name], images_txt=imgs, chunk_rows=300,
                      zero_timestamps=zero)
    got = read_h5_both(outs["port"])
    assert_tree_equal(got, read_h5_both(outs["jax"]))
    assert len(got["ts"]) == 800 and len(got["frames"]) == 4
    assert (got["ts"][0] == 0.0) == zero
    import h5py
    with h5py.File(outs["port"]) as f, h5py.File(outs["jax"]) as g:
        assert sorted(f.attrs) == sorted(g.attrs)
        for k in f.attrs:
            np.testing.assert_array_equal(f.attrs[k], g.attrs[k])


def packaged_h5(rng, path, n=2000, sensor=(24, 32), frames=3):
    xs, ys, ts, ps = stream(rng, n=n, sensor=sensor)
    ep = PD.hdf5_packager(path)
    ex = PD.BagExtractor(ep, max_buffer_size=500)
    ex.packager.set_data_available(frames, 0)
    ex.add_events(xs, ys, ts, ps > 0)
    for i, ft in enumerate(np.linspace(0.2, 0.8, frames)):
        ex.add_image(rng.integers(0, 255, sensor, np.uint8), ft)
    ex.finalize()
    ep.close()
    return xs, ys, ts, ps


def test_h5_to_memmap_read_equal_by_both(rng, tmp_path):
    h5p = str(tmp_path / "scene.h5")
    xs, _, ts, _ = packaged_h5(rng, h5p)
    p_out = PD.h5_to_memmap(h5p, str(tmp_path / "port_mm"), chunk_size=700)
    j_out = JD.h5_to_memmap(h5p, str(tmp_path / "jax_mm"), chunk_size=700)
    got = read_memmap_both(p_out)
    assert_tree_equal({k: v for k, v in got.items() if k != "path"},
                      {k: v for k, v in read_memmap_both(j_out).items()
                       if k != "path"})
    np.testing.assert_array_equal(got["xy"][:, 0], xs)
    np.testing.assert_array_equal(np.asarray(got["t"]).reshape(-1), ts)
    for name in sorted(os.listdir(j_out)):
        assert (open(os.path.join(p_out, name), "rb").read()
                == open(os.path.join(j_out, name), "rb").read()), name
    # a second conversion into the same directory does not clobber it
    again = PD.h5_to_memmap(h5p, p_out)
    assert again == p_out + "_0" and os.path.isdir(again)
    assert PD.find_safe_alternative(p_out) == p_out + "_1"


def test_memmap_to_h5_read_equal_by_both(rng, tmp_path):
    d = str(tmp_path / "src")
    mp = PD.memmap_packager(d)
    xs, ys, ts, ps = stream(rng, n=1200)
    mp.package_events(xs, ys, ts, ps)
    for k, ft in enumerate((0.25, 0.5, 0.75)):
        mp.package_image(rng.integers(0, 255, (24, 32), np.uint8), ft, k)
        mp.package_flow(rng.normal(size=(2, 24, 32)).astype(np.float32),
                        ft, k)
    mp.add_metadata(len(xs), int((ps > 0).sum()), int((ps < 0).sum()),
                    ts[-1] - ts[0], ts[0], ts[-1], 3, 3,
                    sensor_size=(24, 32))
    outs = {}
    for pkg, name in ((PD, "port"), (JD, "jax")):
        outs[name] = str(tmp_path / f"{name}.h5")
        pkg.memmap_to_h5(d, outs[name], chunk_size=500)
    got = read_h5_both(outs["port"])
    assert_tree_equal(got, read_h5_both(outs["jax"]))
    np.testing.assert_array_equal(got["xs"], xs)
    np.testing.assert_array_equal(got["ps"], ps)
    import h5py
    with h5py.File(outs["port"]) as f:
        assert list(f.attrs["sensor_resolution"]) == [24, 32]
        assert len(f["flow"]) == 3


def test_add_attribute_and_paths(rng, tmp_path):
    import h5py
    h5p = str(tmp_path / "a.h5")
    packaged_h5(rng, h5p, n=100, frames=1)
    PD.add_attribute([h5p], "source", "esim")
    PD.add_attribute([h5p], "would_be", "skipped", dry_run=True)
    with h5py.File(h5p) as f:
        assert f.attrs["source"] == "esim" and "would_be" not in f.attrs
    (tmp_path / "b.h5").touch()
    lst = tmp_path / "list.txt"
    lst.write_text("x.h5\ny.h5\n")
    for arg in (str(tmp_path), str(lst), h5p):
        assert PD.get_filepaths_from_path_or_file(arg) == \
            JD.get_filepaths_from_path_or_file(arg)


def test_rosbag_writer_fed_messages(rng, tmp_path):
    """The message-fed writer (events one by one, frames, flow) writes the
    file JAX's writer writes; ``extract_rosbag`` raises without ROS."""
    xs, ys, ts, ps = stream(rng, n=600)
    ts = ts + 5.0
    outs = {}
    for pkg, name in ((PD, "port"), (JD, "jax")):
        outs[name] = str(tmp_path / f"{name}.h5")
        ep = pkg.hdf5_packager(outs[name])
        ex = pkg.BagExtractor(ep, zero_timestamps=True, max_buffer_size=128)
        for i in range(len(xs)):  # one message per event
            ex.add_event(int(xs[i]), int(ys[i]), float(ts[i]), ps[i] > 0)
            if i in (200, 400):
                ex.add_image(np.full((24, 32), i % 255, np.uint8),
                             float(ts[i]))
                ex.add_flow(np.ones((2, 24, 32), np.float32) * i,
                            float(ts[i]))
        ex.finalize()
        ep.close()
    got = read_h5_both(outs["port"])
    assert_tree_equal(got, read_h5_both(outs["jax"]))
    assert len(got["ts"]) == 600 and got["ts"][0] == 0.0
    with pytest.raises(ImportError, match="rosbag"):
        PD.extract_rosbag(str(tmp_path / "none.bag"),
                          str(tmp_path / "x.h5"), "/dvs/events")


def test_converter_mains(rng, tmp_path, capsys):
    """Every converter's ``main`` writes what its function writes."""
    import importlib

    import h5py

    (add_hdf5_attribute, h5_to_memmap, memmap_to_h5, rosbag_to_h5,
     txt_events) = (importlib.import_module(
         f"event_utils_tpu_torch.data_formats.{m}") for m in (
         "add_hdf5_attribute", "h5_to_memmap", "memmap_to_h5",
         "rosbag_to_h5", "txt_events"))

    xs, ys, ts, ps = stream(rng, n=500)
    evp = str(tmp_path / "events.txt")
    PD.write_txt_events(evp, xs, ys, ts, ps)
    h5p = str(tmp_path / "from_txt.h5")
    txt_events.main([evp, h5p, "--sensor", "24", "32", "--chunk_rows",
                     "100", "--zero_timestamps"])
    d = read_h5_both(h5p)
    np.testing.assert_array_equal(d["xs"], xs)
    with h5py.File(h5p) as f:
        assert list(f.attrs["sensor_resolution"]) == [24, 32]

    mm_root = str(tmp_path / "mm")
    h5_to_memmap.main([h5p, "--output_dir", mm_root])
    mm = os.path.join(mm_root, "from_txt")
    with open(os.path.join(mm, "metadata.json")) as f:
        assert json.load(f)["num_events"] == 500
    np.testing.assert_array_equal(read_memmap_both(mm)["xy"][:, 1], ys)

    back = str(tmp_path / "back.h5")
    memmap_to_h5.main([mm, back, "--chunk_size", "64"])
    assert_tree_equal(read_h5_both(back)["xs"], d["xs"])

    add_hdf5_attribute.main([back, "scale", "1,2,3", "--type", "int_list"])
    with h5py.File(back) as f:
        assert list(f.attrs["scale"]) == [1, 2, 3]

    bags = tmp_path / "bags"
    bags.mkdir()
    (bags / "a.bag").touch()
    with pytest.raises(ImportError):
        rosbag_to_h5.main([str(bags), "--output_dir", str(tmp_path / "x")])
    out = capsys.readouterr().out
    assert "wrote" in out and "->" in out


def test_console_scripts_name_the_ports_mains():
    """Every ``event-utils-tpu-torch-*`` console script of pyproject.toml
    resolves to a ``main`` of the port, one for each CLI and converter:
    one beside each of the JAX package's, and the port's own detection
    CLI (``detect``, RVT), which the JAX package does not have."""
    import importlib
    import tomllib
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ours = {k: v for k, v in scripts.items()
            if k.startswith("event-utils-tpu-torch-")}
    assert len(ours) == 19
    jax_names = {k[len("event-utils-tpu-"):] for k in scripts
                 if not k.startswith("event-utils-tpu-torch-")}
    assert {k[len("event-utils-tpu-torch-"):] for k in ours} == \
        jax_names | {"detect"}
    for target in ours.values():
        mod, fn = target.split(":")
        assert mod.startswith("event_utils_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod), fn))
