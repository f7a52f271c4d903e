"""Host data: the port's dataset cache, loader (with and without the native
decode pool) and PPM decoder against yolojax's on the same files."""

import json
import os
import sys

import numpy as np
import pytest

import yolojax.data.native
from yolojax.data import cache as jax_cache
from yolojax.data.loader import Loader as JaxLoader
from yolojax.data.loader import LoaderConfig as JaxLoaderConfig
from yolojax_torch.data import cache, loader, native

from .util import write_synthetic_coco, write_synthetic_voc

CACHE_FIELDS = ("paths", "sizes", "offsets", "boxes", "classes", "difficult")


def assert_caches_equal(got, want):
    for field in CACHE_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.names == want.names


def build_both(tmp_path, datasets, names):
    got = cache.build_cache(str(tmp_path / "port"), "test", datasets, names)
    want = jax_cache.build_cache(str(tmp_path / "jax"), "test", datasets,
                                 names)
    assert_caches_equal(got, want)
    for d in ("port", "jax"):
        with open(tmp_path / d / "names.txt") as f:
            assert tuple(f.read().split()) == want.names
    # each package loads the other's file to the same arrays
    assert_caches_equal(cache.load_cache(str(tmp_path / "jax"), "test"), want)
    assert_caches_equal(jax_cache.load_cache(str(tmp_path / "port"), "test"),
                        want)
    return got


def test_voc_cache_matches_jax(tmp_path):
    write_synthetic_voc(str(tmp_path / "voc"), n_images=12, seed=1,
                        difficult_frac=0.3)
    got = build_both(tmp_path, [{"kind": "voc", "root": str(tmp_path / "voc"),
                                 "image_set": "test"}], cache.VOC_NAMES)
    assert got.difficult.any() and not got.difficult.all()


def test_coco_cache_matches_jax(tmp_path):
    ann, img_dir = write_synthetic_coco(str(tmp_path / "coco"), n_images=7,
                                        seed=2)
    for names in (None, ("blue", "red", "green")):  # category order or given
        got = build_both(tmp_path, [{"kind": "coco", "ann_json": ann,
                                     "image_dir": img_dir}], names)
        assert len(got) == 7 and not got.difficult.any()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_loader_epoch_matches_jax(tmp_path, monkeypatch, use_native, shard):
    """Batches of one shuffled epoch, ragged last batch kept. Images of the
    canvas size, so neither package resizes: the canvases are the decoded
    pixels and must agree to 1e-6 whichever decoder ran."""
    if use_native:
        assert native.available() and yolojax.data.native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(yolojax.data.native, "available", lambda: False)
    write_synthetic_voc(str(tmp_path / "voc"), n_images=11, size=(64, 64),
                        seed=3, difficult_frac=0.3)
    c = cache.build_cache(str(tmp_path / "c"), "test",
                          [{"kind": "voc", "root": str(tmp_path / "voc"),
                            "image_set": "test"}])
    kw = dict(batch_size=4, canvas_dim=64, max_boxes=3, num_threads=2,
              drop_remainder=False, seed=5, shard_index=shard[0],
              shard_count=shard[1])
    port = loader.Loader(c, loader.LoaderConfig(**kw))
    ref = JaxLoader(c, JaxLoaderConfig(**kw))
    assert (port._native is None) == (ref._native is None) == (not use_native)
    got = list(port.epoch(1))
    want = list(ref.epoch(1))
    assert len(got) == len(want) == len(port) == len(ref)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_loader_letterboxes_like_jax(tmp_path, monkeypatch):
    """Images of another size than the canvas: the boxes agree exactly and
    the canvases within the letterbox's tolerance (bilinear in two
    libraries, tests/test_torch_slice.py::test_letterbox_matches_cv2)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(yolojax.data.native, "available", lambda: False)
    write_synthetic_voc(str(tmp_path / "voc"), n_images=5, size=(96, 64),
                        seed=4)
    c = cache.build_cache(str(tmp_path / "c"), "test",
                          [{"kind": "voc", "root": str(tmp_path / "voc"),
                            "image_set": "test"}])
    kw = dict(batch_size=2, canvas_dim=48, num_threads=2,
              drop_remainder=True)
    for g, w in zip(loader.Loader(c, loader.LoaderConfig(**kw)).epoch(0),
                    JaxLoader(c, JaxLoaderConfig(**kw)).epoch(0)):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=2e-4)
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_ppm_decoder_matches_cv2(tmp_path):
    import cv2

    rgb = np.random.RandomState(6).randint(0, 256, (37, 53, 3), np.uint8)
    ours, theirs = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    loader.write_ppm(ours, rgb)
    cv2.imwrite(theirs, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    commented = str(tmp_path / "c.ppm")
    with open(commented, "wb") as f:  # header comment, spaces, one line
        f.write(b"P6 # made by hand\n53   37\n# max\n255\n" + rgb.tobytes())
    for path in (ours, theirs, commented):
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        got = loader.read_ppm(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rgb)
        np.testing.assert_array_equal(loader.decode_image(path), rgb)


def test_decoder_names_the_file_without_cv2(tmp_path, monkeypatch):
    import cv2

    png = str(tmp_path / "a.png")
    rgb = np.random.RandomState(7).randint(0, 256, (9, 11, 3), np.uint8)
    cv2.imwrite(png, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(loader.decode_image(png), rgb)  # via cv2
    ppm = str(tmp_path / "a.ppm")
    loader.write_ppm(ppm, rgb)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(loader.decode_image(ppm), rgb)
    with pytest.raises(RuntimeError, match=r"a\.png.*cv2"):
        loader.decode_image(png)


def test_ppm_cache_loads_like_png(tmp_path):
    """A COCO set written as PPM and as PNG (both lossless): the loader's
    batches are the same, the PPM through numpy, the PNG through cv2."""
    import cv2

    rng = np.random.RandomState(8)
    images, anns = [], []
    for fmt in ("ppm", "png"):
        os.makedirs(tmp_path / fmt)
    for i, (h, w) in enumerate(((40, 60), (64, 64), (50, 30))):
        rgb = rng.randint(0, 256, (h, w, 3), np.uint8)
        loader.write_ppm(str(tmp_path / "ppm" / f"{i}.img"), rgb)
        cv2.imwrite(str(tmp_path / "png" / f"{i}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        images.append({"id": i, "file_name": f"{i}.img", "width": w,
                       "height": h})
        anns.append({"id": i + 1, "image_id": i, "category_id": 1,
                     "bbox": [2, 3, 10, 12], "iscrowd": 0})
    batches = {}
    for fmt in ("ppm", "png"):
        if fmt == "png":
            for im in images:
                im["file_name"] = im["file_name"].replace(".img", ".png")
        ann = tmp_path / f"{fmt}.json"
        ann.write_text(json.dumps({"images": images, "annotations": anns,
                                   "categories": [{"id": 1, "name": "dog"}]}))
        c = cache.build_cache(str(tmp_path / f"c_{fmt}"), "test",
                              [{"kind": "coco", "ann_json": str(ann),
                                "image_dir": str(tmp_path / fmt)}], ("dog",))
        lo = loader.Loader(c, loader.LoaderConfig(
            batch_size=2, canvas_dim=32, drop_remainder=False, num_threads=2))
        batches[fmt] = list(lo.epoch(0, shuffle=False))
    assert len(batches["ppm"]) == 2
    for g, w in zip(batches["ppm"], batches["png"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
