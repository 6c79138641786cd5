"""The port's serve loop against a JAX replica of ``repro.launch.serve``.

``repro_torch.launch.serve.serve`` (teacher-forced prefill through decode
steps, then greedy decode) and the loop of ``repro/launch/serve.py``
(lines 47-60, replicated here on the JAX ``Model``) run on the same
converted params and prompts; the generated token ids must be equal. The
embedding table is scaled up in both, so that random weights give varied
tokens rather than one repeated id.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def _jax_serve(model, params, prompts, gen, cache_len):
    """repro/launch/serve.py:47-60 on given params and prompts."""
    b, prompt_len = prompts.shape
    decode = jax.jit(model.decode_step)
    cache = model.init_cache(b, cache_len)
    tok = prompts[:, :1]
    out_tokens = [tok]
    for t in range(prompt_len + gen - 1):
        pos = jnp.full((b,), t, jnp.int32)
        logits, cache = decode(params, tok, pos, cache)
        if t + 1 < prompt_len:
            tok = prompts[:, t + 1:t + 2]
        else:
            tok = jnp.argmax(logits[:, -1:, :model.cfg.vocab], axis=-1).astype(jnp.int32)
            out_tokens.append(tok)
    return np.asarray(jnp.concatenate(out_tokens[1:], axis=1))


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b", "stablelm-12b", "zamba2-7b"])
def test_serve_tokens_match_jax(arch):
    cfg = jax_configs.get_arch(arch).smoke_variant()
    mj = jax_build_model(cfg)
    params_j = mj.init(jax.random.PRNGKey(0))
    params_j["embed"]["table"] = params_j["embed"]["table"] * 50.0
    b, prompt_len, gen, cache_len = 4, 32, 16, 128  # the reference CLI's defaults
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (b, prompt_len)).astype(np.int32)
    want = _jax_serve(mj, params_j, jnp.asarray(prompts), gen, cache_len)

    mt = build_model(get_arch(arch).smoke_variant(), device="cpu")
    res = pt_serve.serve(mt, from_numpy(params_j, device="cpu"),
                         torch.from_numpy(prompts).long(), gen, cache_len)
    assert res.steps == prompt_len + gen - 1 and res.seconds > 0
    assert res.logits.shape == (b, 1, 512) and bool(torch.isfinite(res.logits).all())
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert len(np.unique(want)) > 1


def test_cli_runs_on_the_cpu(capsys):
    pt_serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "4", "--gen", "3", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert "6 decode steps" in out and "ms/step" in out and "tok/s" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_cli_serves_a_moe_arch_on_the_cpu(capsys, arch):
    _serve_cli_on_the_cpu(capsys, arch)


@pytest.mark.parametrize("arch", ["stablelm-12b", "zamba2-7b"])
def test_cli_serves_stablelm_and_the_hybrid_on_the_cpu(capsys, arch):
    _serve_cli_on_the_cpu(capsys, arch)


def _serve_cli_on_the_cpu(capsys, arch):
    pt_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                   "--prompt-len", "4", "--gen", "3", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "6 decode steps" in out and "on cpu" in out
    ids = [int(t) for t in out.split("generated token ids (seq 0):")[1].strip(" []\n").split(",")]
    assert len(ids) == 3 and all(0 <= t < 512 for t in ids)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no card")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_serve.main(["--arch", "smollm-360m", "--smoke"])
