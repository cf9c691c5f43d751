"""The port's checkpoints (``pgdvs_tpu_torch.engines.checkpoint``): save /
list / retention / restore round trips of torch state dicts,
``modules_not_to_save``, ``epoch=`` selection, and the run config, whose
``config.json`` equals, as loaded JSON, the JAX package's
``save_run_config`` output for the same dict."""

import dataclasses
import json
import pathlib

import pytest
import torch

from pgdvs_tpu.engines import checkpoint as jckpt
from pgdvs_tpu_torch.engines import checkpoint as ckpt
from pgdvs_tpu_torch.renderers.config import RenderConfig


def _modules(seed=0):
    torch.manual_seed(seed)
    return {"gnt": torch.nn.Linear(4, 3), "feature_net": torch.nn.Conv2d(2, 3, 3),
            "frozen": torch.nn.Linear(2, 2)}


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_save_list_restore_round_trip(tmp_path):
    mods = _modules()
    opt = torch.optim.Adam(mods["gnt"].parameters(), lr=1e-3)
    mods["gnt"](torch.ones(2, 4)).sum().backward()
    opt.step()
    path = ckpt.save_checkpoint(tmp_path, mods, opt_state=opt, epoch=2, step=40)
    assert path == tmp_path.absolute() / "epoch_2-step_40"
    assert (path / ckpt.STATE_FILE).is_file()
    assert ckpt.list_checkpoints(tmp_path) == [(2, 40, path)]

    fresh = _modules(seed=1)
    payload, (e, s) = ckpt.restore_checkpoint(tmp_path, template=fresh)
    assert (e, s) == (2, 40)
    for name in mods:
        _same(fresh[name].state_dict(), mods[name].state_dict())
    opt2 = torch.optim.Adam(fresh["gnt"].parameters(), lr=1e-3)
    opt2.load_state_dict(payload["opt_state"])
    assert opt2.state_dict()["state"][0]["step"] == opt.state_dict()["state"][0]["step"]
    _same({k: v for k, v in opt2.state_dict()["state"][0].items()},
          {k: v for k, v in opt.state_dict()["state"][0].items()})


def test_modules_not_to_save_are_left_out(tmp_path):
    mods = _modules()
    ckpt.save_checkpoint(tmp_path, mods, modules_not_to_save=("frozen",))
    payload, _ = ckpt.restore_checkpoint(tmp_path)
    assert sorted(payload["params"]) == ["feature_net", "gnt"]
    assert "opt_state" not in payload
    _same(payload["params"]["gnt"], mods["gnt"].state_dict())
    template = _modules(seed=3)
    before = template["frozen"].state_dict()
    ckpt.restore_checkpoint(tmp_path, template=template)
    _same(template["frozen"].state_dict(), before)


def test_state_dicts_are_accepted_as_they_are(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    ckpt.save_checkpoint(tmp_path, {"net": sd})
    payload, _ = ckpt.restore_checkpoint(tmp_path)
    _same(payload["params"]["net"], sd)


def test_retention_keeps_the_newest(tmp_path):
    mods = _modules()
    for e, s in ((0, 10), (1, 20), (1, 25), (2, 30)):
        ckpt.save_checkpoint(tmp_path, mods, epoch=e, step=s, keep=2)
    assert [(e, s) for e, s, _ in ckpt.list_checkpoints(tmp_path)] == [(1, 25), (2, 30)]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["epoch_1-step_25", "epoch_2-step_30"]


def test_list_ignores_other_entries(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "epoch_x-step_1").mkdir()
    (tmp_path / "epoch_3-step_7").mkdir()
    assert [(e, s) for e, s, _ in ckpt.list_checkpoints(tmp_path)] == [(3, 7)]
    assert ckpt.list_checkpoints(tmp_path / "absent") == []


def test_restore_by_epoch(tmp_path):
    for e, s, seed in ((0, 5, 0), (1, 9, 1), (1, 12, 2), (3, 20, 3)):
        ckpt.save_checkpoint(tmp_path, _modules(seed), epoch=e, step=s)
    payload, es = ckpt.restore_checkpoint(tmp_path, epoch=1)
    assert es == (1, 12)
    _same(payload["params"]["gnt"], _modules(2)["gnt"].state_dict())
    assert ckpt.restore_checkpoint(tmp_path)[1] == (3, 20)
    with pytest.raises(FileNotFoundError, match="epoch 2"):
        ckpt.restore_checkpoint(tmp_path, epoch=2)


def test_restore_without_checkpoints(tmp_path):
    assert ckpt.restore_checkpoint(tmp_path) == (None, None)
    assert ckpt.restore_checkpoint(tmp_path / "absent", epoch=1) == (None, None)


def test_run_config_matches_jax(tmp_path):
    cfg = {"render_cfg": dataclasses.asdict(RenderConfig(n_coarse_samples_per_ray=64)),
           "out_dir": pathlib.Path("/runs/a"), "seed": 3, "lr": 5e-4, "tags": ["x", 1]}
    ckpt.save_run_config(tmp_path / "t", cfg)
    jckpt.save_run_config(tmp_path / "j", cfg)
    got = json.loads((tmp_path / "t" / "config.json").read_text())
    ref = json.loads((tmp_path / "j" / "config.json").read_text())
    assert got == ref
    assert (tmp_path / "t" / "config.json").read_text() == (
        tmp_path / "j" / "config.json").read_text()
    assert ckpt.load_run_config(tmp_path / "t") == jckpt.load_run_config(tmp_path / "j") == ref
    assert ckpt.load_run_config(tmp_path / "absent") is None
