"""The port's quantize_model CLI (mxnet_tpu_torch.tools.quantize_model) on
the CPU with --model mlp --device cpu: exit code 0 with an artifact,
1 for a malformed artifact or input, 3 for a poisoned calibration batch
(and nothing written); --check, --serve-smoke, --json and --batch; the
--symbol/--params mode; the same artifact as the JAX package's CLI on
the same seed (symbol, int8 params and gate report); and the module's
entry point run as ``python -m``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.tools import quantize_model as qm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_quantize_emits_a_gated_artifact(tmp_path, capsys):
    art = str(tmp_path / "art")
    rc = qm.main(["--model", "mlp", "--device", "cpu", "--out", art,
                  "--seed", "1", "--json"])
    assert rc == 0
    summary = _json_line(capsys)
    assert summary["status"] == "emitted" and summary["out"] == art
    assert summary["quantized_layers"] == 3
    assert summary["data_shape"] == [8, 16]
    assert summary["delta"] <= summary["max_delta"]
    assert os.path.exists(os.path.join(art, "meta.json"))
    assert tq.check_artifact(art) == []


def test_check_ok_and_malformed(tmp_path, capsys):
    art = str(tmp_path / "art")
    assert qm.main(["--model", "mlp", "--device", "cpu", "--out",
                    art]) == 0
    capsys.readouterr()
    assert qm.main(["--check", art]) == 0
    assert "OK (int8, 3 quantized layers" in capsys.readouterr().out
    # a meta that lost its int8 tag and a gate field: malformed, 1
    meta_path = os.path.join(art, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["dtype_policy"] = "f32"
    del meta["calib_sha256"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert qm.main(["--check", art]) == 1
    err = capsys.readouterr().err
    assert "dtype_policy" in err and "calib_sha256" in err
    # no commit point at all
    os.remove(meta_path)
    assert qm.main(["--check", art]) == 1
    assert qm.main(["--check", str(tmp_path / "missing")]) == 1


def test_poisoned_calibration_refuses_with_3(tmp_path, capsys):
    poison = tmp_path / "poison.npy"
    np.save(str(poison), np.full((8, 16), np.nan, np.float32))
    out = tmp_path / "art"
    rc = qm.main(["--model", "mlp", "--device", "cpu", "--out", str(out),
                  "--calib", str(poison), "--json"])
    assert rc == 3
    assert _json_line(capsys)["status"] == "refused"
    assert not (out / "meta.json").exists()


def test_gate_refusal_with_a_tight_delta(tmp_path, capsys):
    """A gate no int8 graph can meet (a max delta below 0): refused, 3,
    nothing written."""
    out = tmp_path / "art"
    rc = qm.main(["--model", "mlp", "--device", "cpu", "--out", str(out),
                  "--topk", "1", "--max-delta", "-1", "--json"])
    assert rc == 3
    assert "REFUSED" in capsys.readouterr().err
    assert not (out / "meta.json").exists()


def test_serve_smoke_and_batch(tmp_path, capsys):
    art = str(tmp_path / "art")
    assert qm.main(["--model", "mlp", "--device", "cpu", "--out", art,
                    "--batch", "5"]) == 0
    _s, _a, _x, meta = tq.load_artifact(art)
    assert meta["data_shape"] == [5, 16] and meta["calib_rows"] == 5
    capsys.readouterr()
    rc = qm.main(["--serve-smoke", art, "--device", "cpu", "--json"])
    assert rc == 0
    assert _json_line(capsys) == {"status": "served", "rows": 5,
                                  "out_shape": [5, 10]}


def test_bad_invocations_exit_nonzero(tmp_path):
    with pytest.raises(SystemExit) as ei:
        qm.main(["--model", "nope", "--device", "cpu", "--out",
                 str(tmp_path / "a")])
    assert "unknown --model" in str(ei.value)
    with pytest.raises(SystemExit) as ei:
        qm.main(["--symbol", "x.json", "--out", str(tmp_path / "a")])
    assert "--params" in str(ei.value)
    with pytest.raises(SystemExit) as ei:
        qm.main(["--model", "mlp"])        # no --out
    assert ei.value.code == 2


def test_symbol_and_params_mode(tmp_path):
    sym, shape = qm.build_mlp()
    args, auxs = qm.init_params(sym, shape, seed=2, ctx=tmx.cpu())
    prefix = str(tmp_path / "m")
    tmx.model.save_checkpoint(prefix, 0, sym, args, auxs)
    calib = tmp_path / "calib.npy"
    np.save(str(calib), np.random.RandomState(0).rand(*shape)
            .astype(np.float32))
    art = str(tmp_path / "art")
    rc = qm.main(["--symbol", prefix + "-symbol.json", "--params",
                  prefix + "-0000.params", "--calib", str(calib),
                  "--device", "cpu", "--out", art])
    assert rc == 0 and tq.check_artifact(art) == []
    with pytest.raises(SystemExit) as ei:
        qm.main(["--symbol", prefix + "-symbol.json", "--params",
                 prefix + "-0000.params", "--device", "cpu", "--out", art])
    assert "--calib" in str(ei.value)


def test_artifact_equals_the_jax_cli(tmp_path):
    from mxnet_tpu.contrib import quantization as jq

    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        import quantize_model as jqm
    finally:
        sys.path.remove(tools)
    import mxnet_tpu as jmx

    jart, tart = str(tmp_path / "j"), str(tmp_path / "t")
    # fresh name scopes: the unnamed relu nodes take their counters' names
    with jmx.name.NameManager():
        assert jqm.main(["--model", "mlp", "--out", jart,
                         "--seed", "3"]) == 0
    with tmx.name.NameManager():
        assert qm.main(["--model", "mlp", "--device", "cpu", "--out", tart,
                        "--seed", "3"]) == 0
    jsym, jargs, jaux, jmeta = jq.load_artifact(jart)
    tsym, targs, taux, tmeta = tq.load_artifact(tart)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert sorted(targs) == sorted(jargs) and not taux and not jaux
    for k in jargs:
        np.testing.assert_array_equal(targs[k].asnumpy(),
                                      jargs[k].asnumpy(), err_msg=k)
    for k in ("topk", "max_delta", "agreement", "delta", "calib_sha256",
              "quantized_layers", "data_shape", "data_dtype"):
        assert tmeta[k] == jmeta[k], k


def test_module_entry_point(tmp_path):
    art = str(tmp_path / "art")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.quantize_model",
         "--model", "mlp", "--device", "cpu", "--out", art, "--json"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1])["status"] == \
        "emitted"
    assert "jax" not in run.stderr.lower()
    run = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.quantize_model",
         "--check", str(tmp_path / "nothing")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 1
