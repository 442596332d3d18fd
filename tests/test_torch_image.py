"""The port's image decode and augmentation against the JAX package's
``data/image.py``, on the CPU.

- Every transform (train and eval, f32 and ``_u8``, sizes 224 and 32)
  gives JAX's record bit for bit (``assert_array_equal``), on JPEGs of
  several sizes and a PNG the test writes with PIL, at epochs 0 and 3.
- The crop is a function of (record bytes, epoch): the same epoch gives
  the same crop, another epoch another, through the loader too.
- ``ensure_registered`` takes any size; a record without the schema's
  keys raises.
- Five ``resnet_tiny`` steps on service batches of an
  ``imagenet_train_u8_32`` JPEG TFRecord corpus (two workers decoding
  and augmenting) follow the JAX ``Trainer`` on the same batches, within
  ``tests/test_torch_vision.py``'s curve tolerance (max |delta| 1e-4
  over the loss, f32).
"""

import io
import os

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
from flax import traverse_util
from PIL import Image

from tensorflow_train_distributed_tpu.data import filesource as jfs
from tensorflow_train_distributed_tpu.data import image as jim
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.training import mixed_precision as jmp
from tensorflow_train_distributed_tpu.training.callbacks import History
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.data import filesource as tfs
from tensorflow_train_distributed_torch.data import image as tim
from tensorflow_train_distributed_torch.data import pipeline as tpl
from tensorflow_train_distributed_torch.data import service as tsv
from tensorflow_train_distributed_torch.data import tfrecord as ttf
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)


def _encoded(rng, h, w, fmt="JPEG"):
    """A smooth random image (so a JPEG keeps structure) as bytes."""
    y, x = np.mgrid[0:h, 0:w]
    base = rng.integers(0, 255, 3)
    arr = ((base + y[..., None] * rng.integers(1, 4, 3)
            + x[..., None] * rng.integers(1, 4, 3)) % 256).astype(np.uint8)
    arr = np.clip(arr.astype(np.int16) + rng.integers(-20, 20, arr.shape),
                  0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def _records():
    rng = np.random.default_rng(0)
    shapes = [(375, 500), (500, 375), (60, 44), (33, 33)]
    recs = [{"image/encoded": _encoded(rng, h, w),
             "image/class/label": np.asarray([i], np.int64)}
            for i, (h, w) in enumerate(shapes)]
    recs.append({"jpeg": _encoded(rng, 90, 70, "PNG"),
                 "label": np.asarray([7], np.int64)})
    return recs


@pytest.mark.parametrize("name", ["imagenet_train_224", "imagenet_eval_224",
                                  "imagenet_train_u8_224",
                                  "imagenet_eval_u8_224",
                                  "imagenet_train_32", "imagenet_eval_32",
                                  "imagenet_train_u8_32",
                                  "imagenet_eval_u8_32"])
def test_transforms_match_jax_bitwise(name):
    jfn, tfn = jfs.resolve_transform(name), tfs.resolve_transform(name)
    size = int(name.rsplit("_", 1)[1])
    train = "train" in name
    assert tfs.transform_is_epoch_aware(tfn) == train
    for i, rec in enumerate(_records()):
        for epoch in ((0, 3) if train else (None,)):
            kw = {} if epoch is None else {"epoch": epoch}
            want, got = jfn(rec, **kw), tfn(rec, **kw)
            assert got.keys() == want.keys() == {"image", "label"}
            assert got["image"].shape == (size, size, 3)
            assert got["image"].dtype == (np.uint8 if "_u8" in name
                                          else np.float32)
            assert got["label"].dtype == np.int32
            np.testing.assert_array_equal(got["image"], want["image"],
                                          err_msg=f"record {i} {kw}")
            np.testing.assert_array_equal(got["label"], want["label"])


def test_decode_and_crops_match_jax():
    rng = np.random.default_rng(3)
    data = _encoded(rng, 120, 90)
    img = tim.decode_image(data)
    np.testing.assert_array_equal(img, jim.decode_image(data))
    assert img.shape == (120, 90, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(tim.center_crop(img, 64),
                                  jim.center_crop(img, 64))
    for seed in range(4):
        np.testing.assert_array_equal(
            tim.random_resized_crop(img, 48, np.random.default_rng(seed)),
            jim.random_resized_crop(img, 48, np.random.default_rng(seed)))
    np.testing.assert_array_equal(tim._normalize(img), jim._normalize(img))


def test_same_epoch_same_crop_other_epoch_another():
    rec = _records()[0]
    fn = tfs.resolve_transform("imagenet_train_u8_224")
    a, b = fn(rec, epoch=2)["image"], fn(rec, epoch=2)["image"]
    np.testing.assert_array_equal(a, b)
    crops = {fn(rec, epoch=e)["image"].tobytes() for e in range(4)}
    assert len(crops) == 4


def test_loader_threads_the_epoch_to_the_crop(tmp_path):
    """Two epochs through the loader over a TFRecord corpus: each record's
    epoch-1 crop differs from its epoch-0 crop and equals the transform's
    at epoch 1."""
    recs = _records()[:4]
    root = _write_corpus(tmp_path, recs, files=1)
    src = ttf.open_tfrecord_dir(root, transform="imagenet_train_u8_32")
    loader = tpl.HostDataLoader(src, tpl.DataConfig(
        global_batch_size=4, shuffle=False, num_epochs=2))
    e0, e1 = list(loader)
    fn = tfs.resolve_transform("imagenet_train_u8_32")
    for i, rec in enumerate(recs):
        assert not np.array_equal(e0["image"][i], e1["image"][i])
        np.testing.assert_array_equal(e1["image"][i],
                                      fn(rec, epoch=1)["image"])


def test_any_size_registers_and_bad_schema_raises():
    for name in ("imagenet_train_96", "imagenet_eval_u8_48"):
        tim.ensure_registered(name)
        fn = tfs.resolve_transform(name)
        size = int(name.rsplit("_", 1)[1])
        out = fn(_records()[2])
        assert out["image"].shape == (size, size, 3)
    tim.ensure_registered("u8_image_to_f32_7")     # not an image name
    with pytest.raises(ValueError, match="Unknown transform"):
        tfs.resolve_transform("imagenet_test_32")
    fn = tfs.resolve_transform("imagenet_eval_32")
    with pytest.raises(KeyError, match="no encoded image"):
        fn({"image": np.zeros((4, 4, 3), np.uint8), "label": 1})
    with pytest.raises(KeyError, match="no label"):
        fn({"image/encoded": _records()[0]["image/encoded"]})


def _write_corpus(root, recs, files=2):
    root = str(root)
    per = -(-len(recs) // files)
    for f in range(files):
        with ttf.TFRecordWriter(os.path.join(root, f"img-{f}.tfrecord")) as w:
            for rec in recs[f * per:(f + 1) * per]:
                w.write_example({"image/encoded": rec.get(
                    "image/encoded", rec.get("jpeg")),
                    "image/class/label": np.asarray(
                        rec.get("image/class/label", rec.get("label")),
                        np.int64)})
    ttf.write_features_sidecar(root, None)
    return root


def test_resnet_tiny_on_service_jpeg_batches_follows_jax(tmp_path):
    rng = np.random.default_rng(0)
    recs = [{"image/encoded": _encoded(rng, int(rng.integers(40, 90)),
                                       int(rng.integers(40, 90))),
             "image/class/label": np.asarray([i % 10], np.int64)}
            for i in range(80)]
    root = _write_corpus(tmp_path, recs)
    spec = tsv.SourceSpec("tfrecord_dir", {
        "root": root, "transform": "imagenet_train_u8_32"})
    with tsv.DataServiceDispatcher(
            spec, tpl.DataConfig(global_batch_size=16, seed=0),
            num_workers=2) as disp:
        batches = [b for _, b in zip(range(5), disp.client())]
    assert batches[0]["image"].dtype == np.uint8
    assert batches[0]["image"].shape == (16, 32, 32, 3)
    # The batches are the JAX transform's crops of the records.
    jfn = jfs.resolve_transform("imagenet_train_u8_32")
    by_label_and_pixels = {jfn(r, epoch=0)["image"].tobytes() for r in recs}
    assert all(img.tobytes() in by_label_and_pixels
               for b in batches for img in b["image"])

    jentry, tentry = jreg.get_entry("resnet_tiny"), treg.get_entry(
        "resnet_tiny")
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtr = JaxTrainer(jentry["task_factory"](), optax.adamw(1e-3), mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5), callbacks=[hist])
    jstate = jtr.create_state(batches[0])
    vars_ = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(jstate.params), sep="/").items()}
    for k, v in traverse_util.flatten_dict(
            fnn.unbox(jstate.model_state["batch_stats"]), sep="/").items():
        vars_[f"batch_stats/{k}"] = np.asarray(v)
    jtr.fit(batches, steps=5, state=jstate)
    ttr = Trainer(treg.make_task(tentry, device="meta"),
                  topt.make_optimizer("adamw", 1e-3),
                  policy=Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5), device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(vars_,
                                                       tentry["config"]))
    tstate, history = ttr.fit(batches, steps=5, state=tstate)
    got = np.array([m["loss"] for _, m in history])
    want = np.array(hist.history["loss"])
    assert len(got) == len(want) == 5
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) <= 1e-4, got - want
