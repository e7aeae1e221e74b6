"""The port's two CLI parsers against the JAX package's, and ``--use_pallas``,
on the CPU.

- Each port parser takes every option string of its JAX twin but a named
  list of differences, which only shrinks: the port's ``--device`` and
  the flags of the TP and multi-host modes it has not ported. Both parsers
  take the four robustness flags the JAX helper gives both
  (``--kv_page_tokens``, ``--kv_pool_gb``, ``--kv_host_spill``,
  ``--score_sink_max_device``) with JAX's defaults, into the config each
  entry point builds.
- ``--use_pallas {auto,true,false}`` takes JAX's three spellings (the
  port reads auto as true), and under ``false`` no entry point reaches a
  kernel wrapper: the three ``flash_*`` names ``models/llama.py`` calls
  are spies that raise, and the batch CLI (scoring, ``--kv_cache``, the MP
  pipeline and DP ranks over two CPU devices) and the serve CLI (one
  engine, a fleet of two replicas, a draft model) all run, with the
  default run's outputs. Under the default the spies are reached.
- Every runtime function between the config and the wrappers takes
  ``use_pallas`` as a required keyword, so a caller cannot drop it.
"""

import dataclasses
import inspect
import pickle

import numpy as np
import pytest
import torch

from bench import BenchTokenizer
from flexible_llm_sharding_tpu import cli as jcli
from flexible_llm_sharding_tpu_torch import cli
from flexible_llm_sharding_tpu_torch.config import FrameworkConfig, LlamaConfig
from flexible_llm_sharding_tpu_torch.models import llama
from flexible_llm_sharding_tpu_torch.ops import flash_attention as fa
from flexible_llm_sharding_tpu_torch.runtime import hostcache, kvpool
from flexible_llm_sharding_tpu_torch.utils.checkpoint import save_params

# The option strings that may differ between the port's parsers and the JAX
# package's. This list only shrinks: a name leaves it when the port ports
# its flag (the test below fails while a listed name is no difference).
ALLOWED_DIFFERENCES = frozenset({
    "--device",  # the port's: cuda (default) or cpu
    "--tensor_parallel",  # TP: not ported yet
    "--coordinator_address", "--num_processes", "--process_id",  # multi-host: not ported yet
})
PARSERS = ("build_parser", "build_serve_parser")
ROBUSTNESS = {"kv_page_tokens": ("16", 16), "kv_pool_gb": ("0", 0.0),
              "kv_host_spill": ("true", True), "score_sink_max_device": ("16", 16)}


def _options(parser) -> set[str]:
    return {s for a in parser._actions for s in a.option_strings}


def _required(name: str) -> list[str]:
    return ["--prompt_pickle", "p.pkl", "--output_file", "o.pkl"] if name == "build_parser" else []


def test_parsers_differ_only_by_the_named_list():
    diffs = {}
    for name in PARSERS:
        ours, theirs = _options(getattr(cli, name)()), _options(getattr(jcli, name)())
        diffs[name] = ours ^ theirs
        assert diffs[name] <= ALLOWED_DIFFERENCES, (name, sorted(diffs[name]))
    # Shrink-only: every listed name is still a difference somewhere.
    assert set().union(*diffs.values()) == ALLOWED_DIFFERENCES


@pytest.mark.parametrize("name", PARSERS)
def test_robustness_flags_parse_on_both_parsers_with_jax_defaults(name, monkeypatch):
    ours, theirs = getattr(cli, name)(), getattr(jcli, name)()
    for dest in ROBUSTNESS:
        assert ours.get_default(dest) == theirs.get_default(dest)
    # Both default to auto, which the port reads as True.
    assert ours.get_default("use_pallas") is True and theirs.get_default("use_pallas") is None
    argv = _required(name)
    for dest, (text, _) in ROBUSTNESS.items():
        argv += [f"--{dest}", text]
    args = ours.parse_args(argv)
    jargs = theirs.parse_args(argv)
    assert {d: getattr(args, d) for d in ROBUSTNESS} == {d: getattr(jargs, d) for d in ROBUSTNESS}
    assert {d: getattr(args, d) for d in ROBUSTNESS} == {d: v for d, (_, v) in ROBUSTNESS.items()}
    built = _built_config(name, argv, monkeypatch)
    assert {d: getattr(built, d) for d in ROBUSTNESS} == {d: v for d, (_, v) in
                                                          ROBUSTNESS.items()}


class _Built(Exception):
    pass


def _built_config(name: str, argv: list[str], monkeypatch) -> FrameworkConfig:
    """The FrameworkConfig the parser's entry point builds from ``argv``."""
    if name == "build_parser":
        return cli.config_from_args(cli.build_parser().parse_args(argv))

    def capture(**kw):
        raise _Built(kw)

    with monkeypatch.context() as m:
        m.setattr(cli, "FrameworkConfig", capture)
        with pytest.raises(_Built) as built:
            cli.serve_main(argv)
    return FrameworkConfig(**built.value.args[0])


@pytest.mark.parametrize("name", PARSERS)
@pytest.mark.parametrize("text,jax_value,value", [("auto", None, True), ("true", True, True),
                                                 ("false", False, False)])
def test_use_pallas_parses_as_jax_and_reaches_the_config(name, text, jax_value, value,
                                                         monkeypatch):
    argv = [*_required(name), "--use_pallas", text]
    assert getattr(cli, name)().parse_args(argv).use_pallas is value
    assert getattr(jcli, name)().parse_args(argv).use_pallas is jax_value
    assert _built_config(name, argv, monkeypatch).use_pallas is value


def test_use_pallas_rejects_other_values():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([*_required("build_parser"), "--use_pallas", "maybe"])


# ---------------------------------------------------------------------------
# --use_pallas false reaches no kernel wrapper, on every entry point
# ---------------------------------------------------------------------------

class _Vocab256(BenchTokenizer):
    VOCAB = 256


PROMPTS = [
    ("the cat sat on the mat and looked at the door", (" then left", " then slept")),
    ("two plus two equals", (" four", " five", " six")),
    ("the cat sat on the mat and looked at the window", (" then left",)),
]
COMMON = ["--device", "cpu", "--dtype", "float32", "--bucket_multiple", "8", "--block_size", "2",
          "--prefetch_depth", "0"]
SCORING = ("flash_causal_attention", "flash_prefix_shared_attention")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny seeded llama checkpoint (2 layers, hidden 64)."""
    d = tmp_path_factory.mktemp("use_pallas_model")
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      max_position_embeddings=512, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2)
    save_params(llama.init_params(torch.Generator().manual_seed(3), cfg), str(d), cfg)
    return str(d)


def _spies(monkeypatch, allow: bool) -> dict[str, int]:
    """Replace the kernel wrappers ``models/llama.py`` calls: with ``allow``
    each spy counts its calls and runs the wrapper, else it raises."""
    reached = dict.fromkeys(fa.KERNELS, 0)
    for name in fa.KERNELS:
        real = getattr(fa, name)

        def spy(*args, _name=name, _real=real, **kw):
            if not allow:
                raise AssertionError(f"{_name} reached under use_pallas=false")
            reached[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(llama, name, spy)
    return reached


def _batch(model_dir, tmp_path, tag, extra):
    ppkl = tmp_path / f"{tag}.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    out = tmp_path / f"{tag}_scores.pkl"
    cli.main(["--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file", str(out),
              *COMMON, *extra], tokenizer=_Vocab256())
    return pickle.loads(out.read_bytes()), pickle.loads((tmp_path / f"{tag}_updated.pkl")
                                                        .read_bytes())


def _serve(model_dir, tmp_path, tag, extra):
    ppkl = tmp_path / f"{tag}.pkl"
    ppkl.write_bytes(pickle.dumps(PROMPTS))
    out = tmp_path / f"{tag}_scores.pkl"
    cli.main(["serve", "--model_path", model_dir, "--prompt_pickle", str(ppkl), "--output_file",
              str(out), *COMMON, "--max_new_tokens", "3", "--stats_interval_s", "0", *extra],
             tokenizer=_Vocab256())
    return pickle.loads(out.read_bytes()), pickle.loads((tmp_path / f"{tag}_updated.pkl")
                                                        .read_bytes())


# (runner, its arguments, the wrappers the default run reaches)
CASES = {
    "scoring": (_batch, [], SCORING),
    "kv_cache": (_batch, ["--kv_cache", "true", "--num_gen_token", "3"], fa.KERNELS),
    "mp_two_stages": (_batch, ["--num_devices", "2"], SCORING),
    "dp_two_ranks": (_batch, ["--num_devices", "2", "--data_parallel", "true", "--kv_cache",
                              "true", "--num_gen_token", "2"], fa.KERNELS),
    "serve": (_serve, [], fa.KERNELS),
    "serve_fleet": (_serve, ["--replicas", "2", "--router_health_poll_s", "0.05"], fa.KERNELS),
    "serve_draft": (_serve, ["--speculative_k", "2", "--draft_model_path", "@model"],
                    ("flash_causal_attention",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_use_pallas_false_reaches_no_kernel_wrapper(case, model_dir, tmp_path, monkeypatch):
    runner, extra, wanted = CASES[case]
    extra = [model_dir if a == "@model" else a for a in extra]
    outs = {}
    for flag in ("auto", "false"):
        hostcache.reset_process_cache()
        kvpool.reset_process_pools()
        with monkeypatch.context() as m:
            reached = _spies(m, allow=flag == "auto")
            outs[flag] = runner(model_dir, tmp_path, f"{case}_{flag}",
                                [*extra, "--use_pallas", flag])
        if flag == "auto":
            assert all(reached[k] > 0 for k in wanted), reached
    (want, want_up), (got, got_up) = outs["auto"], outs["false"]
    assert got_up == want_up
    assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_use_pallas_is_carried_by_replace_and_into_the_layers():
    """``dataclasses.replace`` (the long-context split's normal-path config,
    a DP rank's) keeps the flag."""
    cfg = FrameworkConfig(use_pallas=False)
    assert dataclasses.replace(cfg, long_context=False).use_pallas is False
    assert FrameworkConfig().use_pallas is True


def _threaded():
    from flexible_llm_sharding_tpu_torch.runtime import decode, draft, executor

    return {
        "llama.prefix_suffix_layer": llama.prefix_suffix_layer,
        "llama.suffix_only_layer": llama.suffix_only_layer,
        "llama.decode_step_layer": llama.decode_step_layer,
        "llama.forward_full": llama.forward_full,
        "executor.apply_segments": executor.apply_segments,
        "executor.process_block": executor.process_block,
        "decode.prefill_decoders": decode.prefill_decoders,
        "decode.suffix_prefill_decoders": decode.suffix_prefill_decoders,
        "decode.decode_decoders": decode.decode_decoders,
        "decode.fused_decode_steps": decode.fused_decode_steps,
        "draft.DraftModel": draft.DraftModel,
    }


@pytest.mark.parametrize("fn", list(_threaded()))
def test_use_pallas_is_a_required_keyword(fn):
    """A caller that does not pass ``use_pallas`` fails at the call
    instead of launching the kernels under ``--use_pallas false``."""
    param = inspect.signature(_threaded()[fn]).parameters["use_pallas"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty
