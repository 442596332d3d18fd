"""``--init-from-hf`` through the port's CLIs against the JAX CLIs, and the
HF and program exports of launcher checkpoints, on the CPU.

On the same tiny HF directory (written by ``transformers``):

- the launcher (``python -m tensorflow_train_distributed_torch``) on
  llama_tiny_sft, bert_tiny_mlm (its task rebuilt around the checkpoint's
  config) and qwen_moe_tiny_lm: three f32 steps' losses within the
  launchers' curve tolerance (max |delta| 1e-4; the first step 1e-5
  relative) and the ``--eval-only`` metrics within 1e-5 relative of the
  JAX launcher's (its 8-device CPU mesh, ``--strategy dp``);
- ``sample.py``'s greedy lines equal JAX ``tools/sample.py``'s, for a
  Llama and a Qwen2-MoE checkpoint;
- ``serve.py --init-from-hf`` answers with the tokens of ``serve.py
  --params-npz`` of the same weights.

The export side: a launcher checkpoint exported as HF
(``export_hf_checkpoint``) and read back with ``--eval-only
--init-from-hf`` evaluates bit for bit as ``--eval-only
--checkpoint-dir`` (the f32 round trip is exact), and a LoRA checkpoint
exports merged, its logits in transformers those of the port's merged
model.
"""

import contextlib
import importlib.util
import io
import json
import os

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from flax import traverse_util

from tensorflow_train_distributed_tpu import launch as jlaunch
from tensorflow_train_distributed_tpu.models import import_hf as JI
from tensorflow_train_distributed_torch import export_hf_checkpoint
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch import sample as tsample
from tensorflow_train_distributed_torch import serve as tserve
from tensorflow_train_distributed_torch import serve_http
from tensorflow_train_distributed_torch.models import registry
from tensorflow_train_distributed_torch.models.lora import (
    load_spec,
    merge_lora,
)
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEC = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, rms_norm_eps=1e-5,
            rope_theta=10_000.0, tie_word_embeddings=False)
# config: (HF model class, its config, seed), each at the registry
# config's shapes.
CHECKPOINTS = {
    "llama_tiny_sft": ("LlamaForCausalLM", transformers.LlamaConfig(
        intermediate_size=128, **_DEC), 0),
    "qwen_moe_tiny_lm": ("Qwen2MoeForCausalLM", transformers.Qwen2MoeConfig(
        intermediate_size=128, moe_intermediate_size=96,
        shared_expert_intermediate_size=112, num_experts=4,
        num_experts_per_tok=2, decoder_sparse_step=1, mlp_only_layers=[],
        norm_topk_prob=False, **_DEC), 7),
    "bert_tiny_mlm": ("BertForMaskedLM", transformers.BertConfig(
        vocab_size=256, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0), 0),
}
FLAGS = ["--precision", "float32", "--log-every", "1", "--seed", "0"]
EVAL = ["--eval-split", "0.25", "--eval-steps", "2"]


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_cli")
    out = {}
    for name, (cls, cfg, seed) in CHECKPOINTS.items():
        torch.manual_seed(seed)
        model = getattr(transformers, cls)(cfg).eval()
        model.save_pretrained(root / name)
        out[name] = (model, str(root / name))
    return out


def _jax(*flags):
    return jlaunch.run(jlaunch.build_parser().parse_args(
        [*flags, "--strategy", "dp", "--platform", "cpu"]))


def _port(*flags):
    return tlaunch.run(tlaunch.build_parser().parse_args(
        [*flags, "--device", "cpu"]))


@pytest.fixture(scope="module")
def launcher_runs(hf_dirs):
    """Both launchers on each checkpoint: 3 steps from the import, then
    ``--eval-only`` of the import (module-scoped: one JAX compile each)."""
    runs = {}
    for name, (_, path) in hf_dirs.items():
        base = ["--config", name, "--init-from-hf", path, *FLAGS]
        train = ["--steps", "3", "--global-batch-size", "8"]
        runs[name] = dict(
            jax=_jax(*base, *train).history["loss"],
            port=_port(*base, *train).history["loss"],
            jax_eval=_jax(*base, *EVAL, "--eval-only").eval_metrics,
            port_eval=_port(*base, *EVAL, "--eval-only").eval_metrics)
    return runs


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_launcher_init_from_hf_matches_the_jax_launcher(launcher_runs,
                                                        name):
    r = launcher_runs[name]
    got, want = np.array(r["port"]), np.array(r["jax"])
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert np.max(np.abs(got - want)) <= 1e-4
    common = set(r["port_eval"]) & set(r["jax_eval"])
    assert {"loss"} <= common
    for k in common:
        np.testing.assert_allclose(r["port_eval"][k], r["jax_eval"][k],
                                   rtol=1e-5, err_msg=k)


def test_init_from_hf_refusals(hf_dirs, tmp_path):
    path = hf_dirs["llama_tiny_sft"][1]
    base = ["--config", "llama_tiny_sft", "--init-from-hf", path]
    for flags, match in (
            (["--params-npz", "x.npz"], "both name the weights"),
            (["--lora-rank", "4"], "no adapters"),
            (["--config", "mnist"], "none of these"),
            (["--config", "transformer_tiny_wmt"], "none of these"),
            (["--config", "llama_125m_lm"], "embed")):
        with pytest.raises(SystemExit, match=match):
            _port(*base, *flags)
    with pytest.raises(SystemExit, match="--init-from-hf"):
        _port("--config", "llama_tiny_sft", "--eval-only", "--eval-steps",
              "1")


def test_bert_checkpoint_must_cover_the_vocabulary(tmp_path):
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64)
    transformers.BertForMaskedLM(cfg).save_pretrained(tmp_path / "small")
    with pytest.raises(SystemExit, match="vocab"):
        _port("--config", "bert_tiny_mlm", "--init-from-hf",
              str(tmp_path / "small"), "--steps", "1")


def test_a_resume_takes_precedence_over_the_import(hf_dirs, tmp_path,
                                                    caplog):
    path = hf_dirs["llama_tiny_sft"][1]
    ck = str(tmp_path / "ck")
    base = ["--config", "llama_tiny_sft", "--init-from-hf", path,
            "--checkpoint-dir", ck, "--global-batch-size", "8", *FLAGS]
    first = _port(*base, "--steps", "2")
    with caplog.at_level("INFO"):
        second = _port(*base, "--steps", "3")
    assert "resumed from step 2" in caplog.text
    assert "initialized from HF checkpoint" not in caplog.text
    assert first.state.step == 2 and second.state.step == 3


# -- sample.py and serve.py ---------------------------------------------------


def _jax_sample_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_sample_cli_hf", os.path.join(REPO, "tools", "sample.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["llama_tiny_sft", "qwen_moe_tiny_lm"])
def test_sample_init_from_hf_prints_the_jax_cli_lines(hf_dirs, name,
                                                      capsys):
    args = ["--config", name, "--init-from-hf", hf_dirs[name][1],
            "--max-new", "10", "--prompt", "1,2,3,4", "--prompt", "9,8,7,6"]
    assert _jax_sample_cli().main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert tsample.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 2


def _serve_tokens(flags) -> list:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert tserve.main(flags) == 0, err.getvalue()[-2000:]
    return [json.loads(x)["tokens"] for x in out.getvalue().splitlines()]


@pytest.mark.parametrize("name", ["llama_tiny_sft", "qwen_moe_tiny_lm"])
def test_serve_init_from_hf_equals_params_npz(hf_dirs, name, tmp_path):
    model, path = hf_dirs[name]
    importer = JI.import_moe if name.startswith("qwen") else JI.import_llama
    _, params = importer(model, remat=False, dtype=jnp.float32)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()})
    base = ["--config", name, "--max-new", "8", "--slots", "2",
            "--cache-len", "64", "--prompt", "5,6,7", "--prompt",
            "1,2,3,4,5,6,7,8,9", "--device", "cpu"]
    want = _serve_tokens(base + ["--params-npz", str(npz)])
    got = _serve_tokens(base + ["--init-from-hf", path])
    assert got == want and len(got) == 2


def test_weight_flags_are_exclusive_in_the_serving_clis(hf_dirs, capsys):
    path = hf_dirs["llama_tiny_sft"][1]
    for parse in (serve_http.build_parser().parse_args,
                  lambda a: tsample.build_parser().parse_args(
                      a + ["--prompt", "1"])):
        for other in (["--checkpoint-dir", "ck"], ["--params-npz", "w"]):
            with pytest.raises(SystemExit) as e:
                parse(["--config", "llama_tiny_sft", "--init-from-hf",
                       path, *other])
            assert e.value.code == 2
    assert "not allowed with argument" in capsys.readouterr().err
    args = serve_http.build_parser().parse_args(
        ["--config", "llama_tiny_sft", "--init-from-hf", path])
    assert args.init_from_hf == path
    with pytest.raises(SystemExit, match="no HuggingFace checkpoint"):
        tserve.main(["--config", "llama_tiny_sft", "--init-from-hf",
                     "/nowhere", "--prompt", "1", "--device", "cpu"])


# -- exports of launcher checkpoints ------------------------------------------


def test_export_then_init_from_hf_evaluates_bitwise(tmp_path, capsys):
    """Train, export through the CLI, evaluate the export: the metrics of
    ``--eval-only --checkpoint-dir`` bit for bit (the f32 round trip is
    exact), and transformers loads the directory."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "hf")
    base = ["--config", "llama_tiny_sft", "--global-batch-size", "8",
            *FLAGS, *EVAL]
    _port(*base, "--steps", "2", "--checkpoint-dir", ck)
    assert export_hf_checkpoint.main(["--config", "llama_tiny_sft",
                                      "--checkpoint-dir", ck, "--out",
                                      out]) == 0
    assert "HF checkpoint written" in capsys.readouterr().out
    want = _port(*base, "--eval-only", "--checkpoint-dir", ck).eval_metrics
    got = _port(*base, "--eval-only", "--init-from-hf", out).eval_metrics
    assert got == want
    hf = transformers.AutoModelForCausalLM.from_pretrained(out)
    assert hf.config.vocab_size == 256
    with pytest.raises(SystemExit, match="no checkpoint under"):
        export_hf_checkpoint.main(["--config", "llama_tiny_sft",
                                   "--checkpoint-dir", str(tmp_path / "e"),
                                   "--out", str(tmp_path / "x")])


def test_lora_checkpoint_exports_merged(tmp_path):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "hf")
    _port("--config", "llama_tiny_sft", "--steps", "2", "--global-batch-size",
          "8", "--lora-rank", "4", "--lora-alpha", "8", "--checkpoint-dir",
          ck, *FLAGS)
    assert export_hf_checkpoint.main(["--config", "llama_tiny_sft",
                                      "--checkpoint-dir", ck, "--out",
                                      out]) == 0
    merged = merge_lora(CheckpointManager(ck).restore_params(),
                        load_spec(ck))
    cfg = registry.get_config("llama_tiny_sft")
    model = registry.make_task({"config": cfg}, device="meta").model
    model.load_state_dict(merged, strict=True, assign=True)
    hf = transformers.AutoModelForCausalLM.from_pretrained(out).eval()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                               (2, 16)))
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(tokens).numpy(),
                                   hf(tokens).logits.numpy(), rtol=2e-3,
                                   atol=2e-4)
    sd = torch.load(os.path.join(out, "pytorch_model.bin"),
                    weights_only=True)
    assert torch.equal(sd["model.layers.0.self_attn.q_proj.weight"],
                       merged["layers.0.attention.query.kernel"].t())
    assert not any("lora" in k for k in sd)
