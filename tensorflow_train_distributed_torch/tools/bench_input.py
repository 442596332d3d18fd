"""Host input-pipeline throughput: records/s through JPEG decode and
augment, the way the port feeds ResNet-50.

    python -m tensorflow_train_distributed_torch.tools.bench_input \\
        [--records 512] [--image-hw 256] [--size 224] [--batch 64] \\
        [--workers 2,4]

Host work: the card does nothing here, and the rates are records a
second of host wall time, the host's own metric (measured under
``--device cpu`` too).  ``--device cuda`` (the default, as every tool)
requires a card and holds the card lock, so a run beside a bench on the
card does not share its host cores unseen.  Over one generated corpus of random
JPEGs in TFRecords (seed 0), it drains ``--records`` records in each mode:

- ``inprocess``: ``HostDataLoader`` with ``imagenet_train_<size>`` on the
  calling thread; ``inprocess_u8`` its uint8 variant (the card
  normalises);
- ``workers<N>``: ``data/service.py``'s dispatcher with N worker
  processes (``--data-workers`` of the launcher);
- ``mmap_predecoded``: the same images decoded once into the mmap shard
  layout (``u8_image_to_f32``);
- ``inprocess_native``: ``inprocess_u8`` on the native stager
  (``DataConfig(use_native=True)``: the records transformed and packed
  once, the crops frozen at epoch 0, batches gathered off the GIL).

``decode_modes`` times raw decode alone: PIL, the native libjpeg decoder
(``native/jpeg.py``) on 1, 2 and 4 threads of its pool, and at half
resolution (DCT-domain, one thread).  ``native`` says which decoder the
transforms' ``data.image.decode_image`` chose and why.  The native legs
need the native libraries: where they cannot be built the tool fails
with the compiler's message, as every native caller does.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import os
import sys
import tempfile
import time
import warnings

from tensorflow_train_distributed_torch.tools import bench_lm as B


def _make_corpus(root: str, n: int, hw: int, shards: int = 4) -> None:
    import numpy as np
    from PIL import Image

    from tensorflow_train_distributed_torch.data.tfrecord import (
        TFRecordWriter,
        encode_example,
        write_features_sidecar,
    )

    rng = np.random.default_rng(0)
    per = n // shards
    for s in range(shards):
        with TFRecordWriter(os.path.join(root, f"imgs-{s}.tfrecord")) as w:
            for i in range(per):
                arr = rng.integers(0, 255, (hw, hw, 3)).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG")
                w.write(encode_example({
                    "image/encoded": buf.getvalue(),
                    "image/class/label": np.int64(i % 1000)}))
    write_features_sidecar(root, None)


def _drain(batches, max_records: int, batch_size: int) -> float:
    t0 = time.perf_counter()
    seen = 0
    for _ in batches:
        seen += batch_size
        if seen >= max_records:
            break
    return seen / (time.perf_counter() - t0)


def bench_input(records: int, image_hw: int, size: int, batch: int,
                workers) -> dict:
    import numpy as np
    from PIL import Image

    from tensorflow_train_distributed_torch.data.filesource import (
        open_sharded,
        write_shards,
    )
    from tensorflow_train_distributed_torch.data import image as I
    from tensorflow_train_distributed_torch.data.image import _encoded_bytes
    from tensorflow_train_distributed_torch.data.pipeline import (
        DataConfig,
        HostDataLoader,
    )
    from tensorflow_train_distributed_torch.data.service import (
        DataServiceDispatcher,
        SourceSpec,
    )
    from tensorflow_train_distributed_torch.data.tfrecord import (
        TFRecordSource,
        open_tfrecord_dir,
    )
    from tensorflow_train_distributed_torch.native import jpeg as njpeg

    transform = f"imagenet_train_{size}"
    cfg = DataConfig(global_batch_size=batch, shuffle=True, seed=0,
                     num_epochs=None)
    results, decode = {}, {}
    with tempfile.TemporaryDirectory() as root:
        _make_corpus(root, records, image_hw)
        paths = sorted(os.path.join(root, f) for f in os.listdir(root)
                       if f.endswith(".tfrecord"))
        raw_src = TFRecordSource(paths, None)
        raws = [_encoded_bytes(raw_src[i]) for i in range(len(raw_src))]
        t0 = time.perf_counter()
        for data in raws:
            with Image.open(io.BytesIO(data)) as im:
                np.asarray(im.convert("RGB"), np.uint8)
        decode["pil"] = len(raws) / (time.perf_counter() - t0)
        for threads in (1, 2, 4):
            t0 = time.perf_counter()
            njpeg.decode_batch(raws, num_threads=threads)
            decode[f"native_t{threads}"] = (len(raws)
                                            / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        njpeg.decode_batch(raws, scale_denom=2, num_threads=1)
        decode["native_halfres_t1"] = len(raws) / (time.perf_counter() - t0)

        src = open_tfrecord_dir(root, transform=transform)
        results["inprocess"] = _drain(iter(HostDataLoader(src, cfg)),
                                      records, batch)
        u8 = open_tfrecord_dir(root, transform=f"imagenet_train_u8_{size}")
        results["inprocess_u8"] = _drain(iter(HostDataLoader(u8, cfg)),
                                         records, batch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the frozen crops: known
            results["inprocess_native"] = _drain(iter(HostDataLoader(
                u8, dataclasses.replace(cfg, use_native=True))), records,
                batch)
        for n in workers:
            spec = SourceSpec("tfrecord_dir",
                              {"root": root, "transform": transform})
            with DataServiceDispatcher(spec, cfg, num_workers=n) as disp:
                results[f"workers{n}"] = _drain(iter(disp.client()),
                                                records, batch)

        decoded = [src[i] for i in range(min(len(src), records))]

        class _Decoded:
            def __len__(self):
                return len(decoded)

            def __getitem__(self, i):
                r = decoded[i]
                return {"image": (np.clip(r["image"] * 0.25 + 0.5, 0, 1)
                                  * 255).astype(np.uint8),
                        "label": np.int32(r["label"])}

        mmap_root = os.path.join(root, "mmap")
        write_shards(mmap_root, _Decoded(), num_shards=4)
        mm = open_sharded(mmap_root, transform="u8_image_to_f32")
        results["mmap_predecoded"] = _drain(iter(HostDataLoader(mm, cfg)),
                                            records, batch)
    return {"metric": "input_pipeline_records_per_sec",
            "unit": "records/sec (host)", "value": max(results.values()),
            "records": records, "image_hw": image_hw, "crop": size,
            "batch": batch, "modes": results, "decode_modes": decode,
            "native": dict(zip(("decoder", "why"), I.decoder()))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--records", type=int, default=512,
                   help="records a timed drain")
    p.add_argument("--image-hw", type=int, default=256,
                   help="stored JPEG side (the decode cost)")
    p.add_argument("--size", type=int, default=224,
                   help="output crop (imagenet_train_<size>)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--workers", default="2,4",
                   help="comma list of worker-fleet sizes")
    B.add_device_args(p)
    args = p.parse_args(argv)
    workers = [int(x) for x in args.workers.split(",") if x]

    def run(device):
        rec = bench_input(args.records, args.image_hw, args.size,
                          args.batch, workers)
        rec.update(B.device_fields(device), note="host work: the rates are "
                   "records a second of host wall time")
        return rec

    return B.run_tool(args, "input_pipeline_records_per_sec",
                      "records/sec (host)", run)


if __name__ == "__main__":
    sys.exit(main())
