"""HuggingFace checkpoint directories read and written with torch alone.

The JAX package's importer loads every checkpoint through
``transformers`` (``from_pretrained``, ``AutoConfig``); the card's machine
has neither ``transformers`` nor ``safetensors``, so the port reads the
files itself, from a local directory (there is no network):

- ``config.json`` becomes a namespace (``read_config``) on which the
  importers' ``getattr`` calls behave as on transformers' config object:
  every key of the file is an attribute, a missing field takes the class
  default of transformers 4.57.6 for the checkpoint's ``model_type``
  (``CLASS_DEFAULTS``; these change logits silently: Mistral's 4,096-row
  window, Mixtral's epsilon 1e-5 and rope base 1e6, Gemma's and BERT's
  tied embeddings, Qwen2-MoE's raw top-k gates), and the classes'
  derived fields follow (``num_key_value_heads`` from
  ``num_attention_heads``, Llama's ``head_dim``, Qwen2's window off
  unless ``use_sliding_window``, ``rope_scaling``'s legacy ``type``);
- the weights (``CheckpointReader``): ``model.safetensors`` through a
  small reader of the format (an 8-byte little-endian header length, a
  JSON header of dtype, shape and data offsets per tensor, the bytes),
  mapped into memory and viewed with ``torch.frombuffer``;
  ``pytorch_model.bin`` through ``torch.load(weights_only=True,
  mmap=True)``; and their sharded forms (``*.index.json``).  A tensor is
  read when it is asked for, so an importer that moves each one to the
  device as it goes never holds the whole model on the host.

``write_checkpoint`` writes ``config.json`` and the weights as
``save_pretrained`` does: one ``pytorch_model.bin`` (what the JAX exporter
writes) up to 5 GB, else 5-GB shards and their index, written a layer at
a time.
"""

from __future__ import annotations

import copy
import json
import mmap
import os
import struct
import types
from collections.abc import Mapping
from pathlib import Path

import torch

CONFIG = "config.json"
SAFETENSORS = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"
INDEX_SUFFIX = ".index.json"
MAX_SHARD_BYTES = 5 * 10**9          # save_pretrained's default "5GB"

_COMMON = dict(tie_word_embeddings=True)      # PretrainedConfig's default
_DECODER = dict(hidden_act="silu", rope_theta=10_000.0, rms_norm_eps=1e-6,
                attention_dropout=0.0, tie_word_embeddings=False)
# The config classes' defaults for the fields the importers read
# (transformers 4.57.6), by model_type.
CLASS_DEFAULTS = {
    "llama": dict(
        _DECODER, vocab_size=32_000, hidden_size=4096,
        intermediate_size=11_008, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=None,
        max_position_embeddings=2048, rope_scaling=None,
        attention_bias=False, mlp_bias=False, head_dim=None),
    "mistral": dict(
        _DECODER, vocab_size=32_000, hidden_size=4096,
        intermediate_size=14_336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, head_dim=None,
        max_position_embeddings=131_072, sliding_window=4096),
    "qwen2": dict(
        _DECODER, vocab_size=151_936, hidden_size=4096,
        intermediate_size=22_016, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=32_768, rope_scaling=None,
        use_sliding_window=False, sliding_window=4096,
        max_window_layers=28),
    "gemma": dict(
        _DECODER, vocab_size=256_000, hidden_size=3072,
        intermediate_size=24_576, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=16, head_dim=256,
        hidden_act="gelu_pytorch_tanh", hidden_activation=None,
        max_position_embeddings=8192, attention_bias=False,
        tie_word_embeddings=True),
    "mixtral": dict(
        _DECODER, vocab_size=32_000, hidden_size=4096,
        intermediate_size=14_336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, head_dim=None,
        max_position_embeddings=131_072, rms_norm_eps=1e-5,
        rope_theta=1e6, sliding_window=None, num_experts_per_tok=2,
        num_local_experts=8),
    "qwen2_moe": dict(
        _DECODER, vocab_size=151_936, hidden_size=2048,
        intermediate_size=5632, num_hidden_layers=24,
        num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=32_768, rope_scaling=None,
        use_sliding_window=False, sliding_window=4096,
        max_window_layers=28, decoder_sparse_step=1,
        moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
        num_experts_per_tok=4, num_experts=60, norm_topk_prob=False,
        mlp_only_layers=None, qkv_bias=True),
    "bert": dict(
        _COMMON, vocab_size=30_522, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
        max_position_embeddings=512, type_vocab_size=2,
        layer_norm_eps=1e-12, position_embedding_type="absolute"),
}
# The classes whose __init__ turns num_key_value_heads=None into MHA.
_KV_FROM_HEADS = ("llama", "mistral", "qwen2", "mixtral", "qwen2_moe")


def _require_dir(path) -> Path:
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(
            f"no HuggingFace checkpoint directory at {path} (a local "
            "directory holding config.json and the weights; hub ids need "
            "a download the port does not make)")
    return p


def config_namespace(fields: dict) -> types.SimpleNamespace:
    """A config dict (``config.json``'s contents) as transformers' config
    class for its ``model_type`` would hold it: class defaults under the
    given fields, then the class's derived fields."""
    fields = copy.deepcopy(fields)
    mt = fields.get("model_type")
    if mt not in CLASS_DEFAULTS:
        # No class to take defaults from: the fields as given (the
        # importers' guards name the model_type they refuse).
        return types.SimpleNamespace(**fields)
    cfg = dict(CLASS_DEFAULTS[mt], **fields)
    if mt in _KV_FROM_HEADS and cfg["num_key_value_heads"] is None:
        cfg["num_key_value_heads"] = cfg["num_attention_heads"]
    if mt == "llama" and cfg["head_dim"] is None:
        cfg["head_dim"] = cfg["hidden_size"] // cfg["num_attention_heads"]
    if mt in ("qwen2", "qwen2_moe") and not cfg["use_sliding_window"]:
        cfg["sliding_window"] = None
    if mt == "qwen2_moe" and cfg["mlp_only_layers"] is None:
        cfg["mlp_only_layers"] = []
    rs = cfg.get("rope_scaling")
    if isinstance(rs, dict) and "type" in rs:
        rs["rope_type"] = rs["type"]
    return types.SimpleNamespace(**cfg)


def read_config(path) -> types.SimpleNamespace:
    """``config_namespace`` of the directory's ``config.json``."""
    f = _require_dir(path) / CONFIG
    if not f.is_file():
        raise FileNotFoundError(f"{path} holds no {CONFIG}")
    with open(f) as fh:
        return config_namespace(json.load(fh))


_ST_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


class _SafetensorsFile:
    """One ``.safetensors`` file, mapped copy-on-write (a writable view
    for ``torch.frombuffer`` that never writes the file)."""

    def __init__(self, path: Path):
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._base = 8 + n
        self.entries = header
        for key, e in header.items():
            if e["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {key} has dtype {e['dtype']}, "
                                 f"not one of {sorted(_ST_DTYPES)}")

    def tensor(self, key: str) -> torch.Tensor:
        e = self.entries[key]
        dtype = _ST_DTYPES[e["dtype"]]
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=self._base + begin).view(shape)


class CheckpointReader(Mapping):
    """The tensors of a checkpoint directory by their HF names, each read
    (as a CPU tensor of its stored dtype, backed by the mapped file) when
    it is asked for.  safetensors is preferred where both formats are
    present, as ``from_pretrained`` prefers it."""

    def __init__(self, path):
        root = _require_dir(path)
        self.path = root
        self._where = {}          # name -> shard file
        self._files = {}          # shard file -> opened shard
        for single, is_st in ((SAFETENSORS, True), (TORCH_BIN, False)):
            index = root / (single + INDEX_SUFFIX)
            if (root / single).is_file():
                self._open_all([root / single], is_st)
            elif index.is_file():
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                self._open_all(sorted({root / v for v in
                                       weight_map.values()}), is_st)
                missing = set(weight_map) - set(self._where)
                if missing:
                    raise ValueError(f"{index} names tensors its shards "
                                     f"lack: {sorted(missing)[:4]}")
            else:
                continue
            self.format = "safetensors" if is_st else "bin"
            return
        raise FileNotFoundError(
            f"{path} holds no {SAFETENSORS} or {TORCH_BIN} (nor their "
            f"sharded {INDEX_SUFFIX} forms)")

    def _open_all(self, files, is_st: bool) -> None:
        for f in files:
            if is_st:
                shard = _SafetensorsFile(f)
                names = shard.entries
            else:
                shard = torch.load(f, map_location="cpu", weights_only=True,
                                   mmap=True)
                names = shard
            self._files[f] = shard
            for name in names:
                self._where[name] = f

    def __getitem__(self, key: str) -> torch.Tensor:
        shard = self._files[self._where[key]]
        if isinstance(shard, _SafetensorsFile):
            return shard.tensor(key)
        return shard[key]

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where


def write_checkpoint(out_dir, config: dict, parts) -> Path:
    """``config.json`` and the weights under ``out_dir`` as
    ``save_pretrained(safe_serialization=False)`` lays them out: one
    ``pytorch_model.bin`` when they fit in ``MAX_SHARD_BYTES`` (what the
    JAX exporter writes), else shards ``pytorch_model-0000i-of-0000n.bin``
    and ``pytorch_model.bin.index.json``.  ``parts`` yields dicts of host
    tensors (a layer each); a shard takes whole parts, is written as soon
    as the next part would overflow it and is then dropped, so the host
    holds one shard and one part at a time.  Returns the directory."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("pytorch_model*.bin*"):
        old.unlink()                 # an earlier export's other layout
    (out / CONFIG).write_text(json.dumps(config, indent=2))
    files, weight_map, total = [], {}, 0
    shard, size = {}, 0

    def flush():
        f = out / f"pytorch_model-{len(files) + 1:05d}.part"
        torch.save(shard, f)
        files.append(f)
        weight_map.update(dict.fromkeys(shard, len(files) - 1))

    for part in parts:
        nbytes = sum(t.numel() * t.element_size() for t in part.values())
        if shard and size + nbytes > MAX_SHARD_BYTES:
            flush()
            shard, size = {}, 0
        shard.update(part)
        size += nbytes
        total += nbytes
    flush()
    if len(files) == 1:
        files[0].rename(out / TORCH_BIN)
        return out
    names = [f"pytorch_model-{i + 1:05d}-of-{len(files):05d}.bin"
             for i in range(len(files))]
    for f, name in zip(files, names):
        f.rename(out / name)
    (out / (TORCH_BIN + INDEX_SUFFIX)).write_text(json.dumps(
        {"metadata": {"total_size": total},
         "weight_map": {k: names[i] for k, i in weight_map.items()}},
        indent=2))
    return out


def checkpoint_bytes(path) -> int:
    """Bytes of the files in a checkpoint directory."""
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
