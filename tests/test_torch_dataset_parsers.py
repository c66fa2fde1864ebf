"""Every classification dataset reader of the port against the JAX
package's, on trees in each dataset's own layout written here.

For each class that `apla_tpu.data.datasets.get_dataset_class` resolves
(but `SyntheticMultiLabel`, which the port refuses: ROADMAP A 6), a small
tree in its layout (the layouts of `tests/test_dataset_parsers.py` and the
rest: NABirds, ISIC2019, APTOS2019, DDSM, SUN397, AID, RSSCN7, Aircraft,
the CSV sets, the 19 VTAB tasks; JPEGs and PNGs written with Pillow, grey,
palette and RGB), copied once for each package (the seeded splits write
`val_ids.json` into the dataset's root), and held:

- the records of every mode (train, val, test, "all" where the class has
  it, `train_val`): the same files relative to the root, the same labels,
  in the same order; the same metadata; the same `val_ids.json`;
- the samples: uint8 bit-equal in raw mode (a JPEG through the DCT-scaled
  path, a PNG through the full decode and BICUBIC), float32 within 1e-6
  after the ImageNet recipe's transforms from one generator;
- the names `get_dataset_class` resolves; `compute_stats` within 1e-6.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from apla_tpu.data import datasets as jdata
from apla_tpu_torch.data import datasets as tdata
from apla_tpu_torch.data.loader import DataLoader

TRANSFORMS = {
    "train_transforms": {
        "Resize": {"apply": True, "height": 28, "width": 28},
        "HorizontalFlip": {"apply": True, "p": 0.5},
        "ColorJitter": {"apply": True, "brightness": 0.2, "contrast": 0.2,
                        "saturation": 0.1, "hue": 0.1, "p": 0.8},
        "RandomResizedCrop": {"apply": True, "size": 24,
                              "scale": [0.8, 1.2]},
        "Normalize": True},
    "val_transforms": {
        "Resize": {"apply": True, "height": 28, "width": 28},
        "CenterCrop": {"apply": True, "height": 24, "width": 24},
        "Normalize": True},
}
TRANSFORMS["test_transforms"] = TRANSFORMS["val_transforms"]
RAW_SIZE = 20
MODES = ("train", "val", "test")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(path, seed, mode="RGB"):
    """A small seeded image at `path`: JPEG or PNG by its extension, in
    Pillow `mode` ("RGB", "L" or "P")."""
    rng = np.random.default_rng(seed)
    h, w = 14 + seed % 9, 17 + seed % 7
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([x * 255 // w, y * 255 // h, (x * y * 7 + seed) % 256],
                   -1).astype(np.float64)
    arr = np.clip(arr + rng.normal(0, 20, arr.shape), 0, 255).astype(
        np.uint8)
    im = Image.fromarray(arr)
    if mode == "L":
        im = im.convert("L")
    elif mode == "P":
        im = im.quantize(12)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jpeg = path.lower().endswith((".jpg", ".jpeg"))
    im.save(path, format="JPEG" if jpeg else "PNG")


def _csv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")


def _lines(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(f"{ln}\n" for ln in lines))


# --------------------------------------------------------------------------- #
# one writer per layout: build(data_location) writes the dataset's tree
# --------------------------------------------------------------------------- #

VTAB_EXCLUDED = ("VTAB_oxford_iiit_pet/train/img_261-label_20.png",
                 "VTAB_sun397/train/img_442-label_85.png")


def build_vtab(name):
    def build(root):
        loc = jdata._VTAB_LOCATIONS.get(name, name)
        n = jdata.get_dataset_class(name).n_classes
        for s, split in enumerate(MODES):
            for i in range(3):
                _img(os.path.join(root, loc, split,
                                  f"img_{i}-label_{(5 * i + s) % n}.png"),
                     10 * s + i, ("RGB", "L", "P")[i])
        for bad in VTAB_EXCLUDED:
            if bad.startswith(loc + "/"):
                _img(os.path.join(root, bad), 99)
    return build


NABIRDS_IDS = [f"{i:02x}e1c3a0-7f2b-4d55-9a{i:02d}-b7c1d2e3f4a5"
               for i in range(10)]


def build_nabirds(root, ids=NABIRDS_IDS):
    base = os.path.join(root, "NABirds")
    classes = [2, 10, 100, 7, 10, 2, 955, 7, 100, 2]   # sorted as strings
    rows = []
    for i, (image_id, c) in enumerate(zip(ids, classes)):
        path = f"{c:04d}/{image_id}.jpg"
        _img(os.path.join(base, "images", path), i, "RGB" if i % 3 else "L")
        rows.append((image_id, path, c))
    _csv(os.path.join(base, "data_info.csv"),
         ("image_id", "imagepath", "class_id"), rows)
    _lines(os.path.join(base, "train_image_ids.txt"), ids[:5])
    _lines(os.path.join(base, "val_image_ids.txt"), ids[5:7])
    _lines(os.path.join(base, "test_image_ids.txt"), ids[7:])


def build_ddsm(root):
    base = os.path.join(root, "DDSM")
    for s, split in enumerate(MODES):
        rows = []
        for i in range(3):
            name = f"calc/{split}_{i}.png"
            _img(os.path.join(base, name), 10 * s + i, "L")
            rows.append((name, (i + s) % 2))
        _csv(os.path.join(base, f"{split}.csv"), ("filename", "label"), rows)


ISIC_HEADER = ("image", "MEL", "NV", "BCC", "AK", "BKL", "DF", "VASC", "SCC",
               "UNK")


def build_isic(root):
    base = os.path.join(root, "ISIC2019")
    rows = []
    for i in range(15):
        name = f"ISIC_{i:07d}"
        _img(os.path.join(base, "train", name + ".jpg"), i)
        onehot = ["0.0"] * 9
        onehot[(3 * i) % 8] = "1.0"
        rows.append((name, *onehot))
    _csv(os.path.join(base, "ISIC_2019_Training_GroundTruth.csv"),
         ISIC_HEADER, rows)


def build_aptos(root):
    base = os.path.join(root, "APTOS2019")
    rows = []
    for i in range(12):
        code = f"{i:03x}f{i * 37 % 1000:03d}a9"
        _img(os.path.join(base, "train_images", code + ".png"), i)
        rows.append((code, i % 5))
    _csv(os.path.join(base, "train.csv"), ("id_code", "diagnosis"), rows)


def build_flowers(root):
    base = os.path.join(root, "Flowers102")
    rows = {}
    for s, split in enumerate(MODES):
        rows[split] = []
        for i in range(3):
            name = f"image_{10 * s + i:05d}.jpg"
            _img(os.path.join(base, "images", name), 10 * s + i)
            rows[split].append((name, 1 + (7 * i + s) % 102))
        _csv(os.path.join(base, f"{split}.csv"), ("filename", "label"),
             rows[split])
    _csv(os.path.join(base, "all_labels.csv"), ("filename", "label"),
         [r for split in MODES for r in rows[split]])


def build_sun(root):
    base = os.path.join(root, "SUN397")
    train = [f"/{c[0]}/{c}/sun_{c}{i}.jpg" for c in ("abbey", "bakery",
                                                        "canal")
             for i in range(3)]
    test = [f"/{c[0]}/{c}/sun_{c}t{i}.jpg" for c in ("abbey", "canal")
            for i in range(2)]
    for k, f in enumerate(train + test):
        _img(os.path.join(base, "SUN397", f.lstrip("/")), k)
    _lines(os.path.join(base, "Partitions", "Training_01.txt"), train)
    _lines(os.path.join(base, "Partitions", "Testing_01.txt"), test)
    _lines(os.path.join(base, "val_imagefiles.txt"), [train[4], train[1]])


def build_cifar(name):
    def build(root):
        cls = getattr(jdata, name)
        d = os.path.join(root, name, cls.batch_dir)
        os.makedirs(d)
        rng = np.random.default_rng(0)
        for batch in cls.train_batches + cls.test_batches:
            data = {b"data": rng.integers(0, 256, (20, 3072), dtype=np.uint8),
                    cls.label_key: [int(v) for v in rng.integers(
                        0, cls.n_classes, 20)]}
            with open(os.path.join(d, batch), "wb") as f:
                pickle.dump(data, f)
    return build


def build_simple_csv(name):
    def build(root):
        cls = getattr(jdata, name)
        base = os.path.join(root, name)
        for s, split in enumerate(MODES):
            rows = []
            for i in range(3):
                fname = (f"class_{i}/{split}_{i}.jpg" if name == "MIT_Indoor"
                         else f"{split}_{i}.{'png' if i == 2 else 'jpg'}")
                _img(os.path.join(base, cls.images_subdir, fname),
                     10 * s + i, "L" if name == "Pneumonia" else "RGB")
                rows.append((fname, (i + 2 * s) % cls.n_classes))
            _csv(os.path.join(base, f"{split}.csv"),
                 (cls.filename_col, cls.label_col), rows)
    return build


def build_aid(name):
    def build(root):
        base = os.path.join(root, name)
        files = []
        for c, cls in enumerate(("airport", "beach", "church")):
            for i in range(3):
                fname = f"{cls}_{i}.jpg"
                _img(os.path.join(base, "images", cls, fname), 3 * c + i)
                files.append(fname)
        for s, split in enumerate(MODES):
            _csv(os.path.join(base, f"{split}.csv"), ("filename", "label"),
                 [(f, 0) for f in files[s::3]])
        _csv(os.path.join(base, "all_labels.csv"), ("filename", "label"),
             [(f, 0) for f in files])
    return build


def build_aircraft(root):
    base = os.path.join(root, "Aircraft", "data")
    variants = ("Boeing 737-200", "A320", "DHC-8-100", "Boeing 747-400")
    lines = {}
    for s, split in enumerate(MODES):
        lines[split] = [f"{1000000 + 10 * s + i:07d} {variants[(i + s) % 4]}"
                        for i in range(3)]
        for ln in lines[split]:
            _img(os.path.join(base, "images", ln[:7] + ".jpg"),
                 int(ln[:7]) % 97)
        _lines(os.path.join(base, f"images_variant_{split}.txt"),
               lines[split])
    _lines(os.path.join(base, "images_variant_all.txt"),
           [ln for split in MODES for ln in lines[split]])


def build_cars(root):
    from scipy.io import savemat
    base = os.path.join(root, "StanfordCars", "stanford_cars")
    os.makedirs(os.path.join(base, "devkit"))

    def save_annos(path, img_dir, n, off):
        dt = np.dtype([("fname", object), ("bbox_x1", object),
                       ("class", object)])
        a = np.empty((n,), dtype=dt)
        for i in range(n):
            fname = f"{i + off:05d}.jpg"
            a[i] = (fname, 1, (i % 3) + 1)
            _img(os.path.join(base, img_dir, fname), i + off)
        savemat(path, {"annotations": a})

    save_annos(os.path.join(base, "devkit", "cars_train_annos.mat"),
               "cars_train", 6, 0)
    save_annos(os.path.join(base, "cars_test_annos_withlabels.mat"),
               "cars_test", 4, 100)
    _lines(os.path.join(root, "StanfordCars", "val_imgfiles.txt"),
           ["stanford_cars/cars_train/00000.jpg",
            "stanford_cars/cars_train/00003.jpg"])


def build_dtd(root):
    data = os.path.join(root, "DTD", "dtd", "dtd")
    entries = {"train": ["banded/banded_0001.jpg", "dotted/dotted_0001.jpg",
                         "zigzag/zigzag_0001.jpg"],
               "val": ["banded/banded_0002.jpg"],
               "test": ["dotted/dotted_0002.jpg", "banded/banded_0003.jpg"]}
    k = 0
    for split, lines in entries.items():
        _lines(os.path.join(data, "labels", f"{split}1.txt"), lines)
        for ln in lines:
            _img(os.path.join(data, "images", ln), k)
            k += 1


def build_pets(root):
    base = os.path.join(root, "OxfordIII_Pet", "oxford-iiit-pet")
    trainval = [("Abyssinian_1", 1), ("Abyssinian_2", 1), ("bengal_1", 2),
                ("yorkshire_terrier_3", 37)]
    test = [("Abyssinian_3", 1), ("bengal_2", 2)]
    k = 0
    for split, items in (("trainval", trainval), ("test", test)):
        _lines(os.path.join(base, "annotations", f"{split}.txt"),
               ["#Image CLASS-ID SPECIES BREED ID"]
               + [f"{n} {lb} {lb} 1" for n, lb in items])
        for n, _ in items:
            _img(os.path.join(base, "images", f"{n}.jpg"), k)
            k += 1
    _lines(os.path.join(root, "OxfordIII_Pet", "val_imgfiles.txt"),
           ["oxford-iiit-pet/images/Abyssinian_2.jpg"])


def build_caltech(name):
    def build(root):
        cls = getattr(jdata, name)
        base = os.path.join(root, name, cls.images_dirname)
        k = 0
        for c in ("ant", "BACKGROUND_Google", "bee", "camera"):
            for i in range(5):
                _img(os.path.join(base, c, f"image_{i:04d}."
                                  f"{'png' if i == 4 else 'jpg'}"), k)
                k += 1
    return build


def build_imagenet(root):
    for split in ("train", "val"):
        for c, wnid in enumerate(("n01440764", "n01443537")):
            for i in range(2):
                _img(os.path.join(root, "ImageNet", split, wnid,
                                  f"{wnid}_{i}.{'JPEG' if i else 'jpg'}"),
                     4 * c + i)


VTAB_NAMES = sorted(n for n, v in vars(jdata).items()
                    if isinstance(v, type) and issubclass(v, jdata.VTABDataset)
                    and v is not jdata.VTABDataset)
# name -> (its tree writer, the dataset_params variants to read it with)
TV = ({}, {"train_val": True})
CASES = {
    **{n: (build_vtab(n), TV) for n in VTAB_NAMES},
    "NABirds": (build_nabirds, TV),
    "DDSM": (build_ddsm, ({},)),
    "ISIC2019": (build_isic, TV),
    "APTOS2019": (build_aptos, TV),
    "Flowers102": (build_flowers, ({},)),
    "SUN397": (build_sun, ({},)),
    "CIFAR_10": (build_cifar("CIFAR_10"), TV),
    "CIFAR_100": (build_cifar("CIFAR_100"), TV),
    **{n: (build_simple_csv(n), ({},)) for n in (
        "Colorectal", "StanfordDogs", "CUB_200_2011", "Birdsnap",
        "MIT_Indoor", "Pneumonia")},
    "AID": (build_aid("AID"), ({},)),
    "RSSCN7": (build_aid("RSSCN7"), ({},)),
    "Aircraft": (build_aircraft, ({},)),
    "StanfordCars": (build_cars, TV),
    "DTD": (build_dtd, ({},)),
    "OxfordIII_Pet": (build_pets, ({},)),
    "Caltech_101": (build_caltech("Caltech_101"), ({},)),
    "Caltech_256": (build_caltech("Caltech_256"), ({},)),
    "ImageNet": (build_imagenet, ({},)),
}
# the classes whose readers take a fourth mode (any other mode name): "all"
ALL_MODE = {"NABirds", "Flowers102", "AID", "RSSCN7", "Aircraft",
            "StanfordCars", "DTD", "OxfordIII_Pet"}
META = ("n_classes", "mean", "std", "target_metric", "knn_nhood", "task",
        "is_multiclass", "img_channels")


def _trees(tmp_path, name):
    """The dataset written once and copied: (JAX's root, the port's)."""
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    CASES[name][0](j)
    shutil.copytree(j, t)
    return j, t


def _params(root, **extra):
    return {"data_location": root, **TRANSFORMS, **extra}


def _relative(records, root):
    out = []
    for r in records:
        rec = {"label": r["label"]}
        if "img_path" in r:
            rec["img_path"] = os.path.relpath(r["img_path"], root)
        else:
            rec["img_arr"] = r["img_arr"].tobytes()
        out.append(rec)
    return out


def _val_ids(root):
    found = {}
    for d, _, files in os.walk(root):
        if "val_ids.json" in files:
            with open(os.path.join(d, "val_ids.json")) as f:
                found[os.path.relpath(d, root)] = json.load(f)
    return found


@pytest.mark.parametrize("name", sorted(CASES))
def test_records_match_jax(tmp_path, name):
    jroot, troot = _trees(tmp_path, name)
    modes = MODES + (("all",) if name in ALL_MODE else ())
    for extra in CASES[name][1]:
        for mode in modes:
            ours = tdata.get_dataset_class(name)(_params(troot, **extra),
                                                 mode)
            ref = jdata.get_dataset_class(name)(_params(jroot, **extra),
                                                mode)
            assert type(ours).__name__ == name
            got, want = _relative(ours.data, troot), \
                _relative(ref.data, jroot)
            assert got == want, (mode, extra)
            assert len(ours) == len(ref) > 0, (mode, extra)
            for key in META:
                assert getattr(ours, key) == getattr(ref, key), key
    assert _val_ids(troot) == _val_ids(jroot)


@pytest.mark.parametrize("name", sorted(CASES))
def test_samples_match_jax(tmp_path, name):
    jroot, troot = _trees(tmp_path, name)
    for mode in ("train", "test"):
        ours = tdata.get_dataset_class(name)(_params(troot), mode)
        ref = jdata.get_dataset_class(name)(_params(jroot), mode)
        for i in range(min(len(ref), 4)):
            for seed in (0, 1):
                g1, g2 = (np.random.default_rng((seed, i)) for _ in "ab")
                got, want = ours.__getitem__(i, g1), ref.__getitem__(i, g2)
                assert got["image"].dtype == np.float32
                assert got["image"].shape == (24, 24, 3)
                np.testing.assert_allclose(got["image"], want["image"],
                                           rtol=0, atol=1e-6)
                assert got["label"] == want["label"]
        for ds in (ours, ref):
            ds.raw_mode, ds.raw_size = True, RAW_SIZE
        for i in range(min(len(ref), 4)):
            got = ours[i]["image"]
            assert got.dtype == np.uint8 and got.shape == (RAW_SIZE,
                                                           RAW_SIZE, 3)
            np.testing.assert_array_equal(got, ref[i]["image"])


def test_nabirds_all_digit_ids_match_nothing(tmp_path):
    """pandas reads an all-digit image_id column as int, which the ids of
    the split files (strings) never equal: the JAX reader selects no row,
    and the port's reads it the same way."""
    ids = [str(1000 + i) for i in range(10)]
    for root in ("jax", "port"):
        build_nabirds(str(tmp_path / root), ids)
    for mode in MODES:
        ours = tdata.NABirds(_params(str(tmp_path / "port")), mode)
        ref = jdata.NABirds(_params(str(tmp_path / "jax")), mode)
        assert ours.data == ref.data == []
    ours = tdata.NABirds(_params(str(tmp_path / "port")), "all")
    ref = jdata.NABirds(_params(str(tmp_path / "jax")), "all")
    assert _relative(ours.data, str(tmp_path / "port")) == \
        _relative(ref.data, str(tmp_path / "jax"))
    # the labels: class ids sorted as strings ("10" < "100" < "2" < "7"
    # < "955")
    assert [r["label"] for r in ours.data] == [2, 0, 1, 3, 0, 2, 4, 3, 1, 2]


def test_isic2019_labels_and_split(tmp_path):
    """The one-hot argmax over nine columns (UNK last, never set), 8
    classes; 20% held out, its first half val."""
    build_isic(str(tmp_path))
    params = _params(str(tmp_path))
    splits = {m: tdata.ISIC2019(params, m) for m in MODES}
    assert [len(splits[m]) for m in MODES] == [12, 1, 2]
    labels = {os.path.basename(r["img_path"]): r["label"]
              for m in MODES for r in splits[m].data}
    assert labels == {f"ISIC_{i:07d}.jpg": (3 * i) % 8 for i in range(15)}
    with open(tmp_path / "ISIC2019" / "val_ids.json") as f:
        ids = json.load(f)
    assert len(ids["val_split"]) == 3 and len(ids["train_split"]) == 12


def test_get_dataset_class_resolves_jax_names():
    jax_names = {n for n, v in vars(jdata).items()
                 if isinstance(v, type) and issubclass(v, jdata.BaseSet)}
    ours = {n for n, v in vars(tdata).items()
            if isinstance(v, type) and issubclass(v, tdata.BaseSet)}
    assert ours == jax_names
    for name in sorted(ours):
        cls = tdata.get_dataset_class(name)
        assert cls.__name__ == name
        ref = jdata.get_dataset_class(name)
        for key in META:
            assert getattr(cls, key, None) == getattr(ref, key, None), \
                (name, key)
    # every concrete reader has a layout above
    concrete = ours - {"BaseSet", "VTABDataset", "_SimpleCsvSet",
                       "_CsvWithSeededSplit", "Synthetic",
                       "SyntheticMultiLabel"}
    assert concrete == set(CASES)
    assert tdata.get_dataset_class("SyntheticMultiLabel").is_multiclass \
        is False
    for name in ("NoSuchSet", "np", "read_csv"):
        with pytest.raises(KeyError, match="Unknown dataset"):
            tdata.get_dataset_class(name)


def test_compute_stats_matches_jax(tmp_path):
    build_imagenet(str(tmp_path))
    params = _params(str(tmp_path))
    ours = DataLoader(tdata.ImageNet(params, "val"), batch_size=2)
    ref = jdata.ImageNet(params, "val")
    batches = [{"image": np.stack([ref.__getitem__(i)["image"]
                                   for i in range(k, k + 2)])}
               for k in range(0, len(ref), 2)]
    want = jdata.compute_stats(batches)
    got = tdata.compute_stats(ours)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # numpy batches too
    for a, b in zip(tdata.compute_stats(batches), want):
        np.testing.assert_array_equal(a, b)
