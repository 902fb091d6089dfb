"""A configuration names its encoder family, and everything that belongs to
the encoder comes from one module found by name (``perfbench/families/``):
``conv-vae`` gives what the harness built for it before it had families,
an unknown family or a training cell of another family fails at
``load_cell``, and a family added as one file is found and run with no edit
to any other file of the harness."""

from __future__ import annotations

import dataclasses
import json
import shutil

import pytest
import torch

from perfbench import families, harness
from perfbench.reference import encoder as ref_encoder
from perfbench.tests import tiny
from perfbench.yardstick import flops

M = tiny.manifest()
CONV_VAE = [c["name"] for c in M["configs"] if families.name_of(harness.load_config(c["name"])) == "conv-vae"]
# least FLOPs of a chunk (mel + 2 x encoder MAC) as yardstick/flops.py counted them before families
CHUNK_FLOPS = {"vae-stride": 443_429_120, "vae-avgpool": 477_049_088}


def vae_config_before_families(c):
    """The port's config as the harness built it before families (a frozen copy)."""
    from anuraxla_torch.models.vae import VAEConfig

    return VAEConfig(latent_dim=c["latent_dim"], widths=tuple(c["widths"]), dense_width=c["dense_width"],
                     groups=c["groups"], input_hw=tuple(c["input_hw"]), conv_padding=c["conv_padding"],
                     gn_eps=c["gn_eps"], activation=c["activation"], downsample=c["downsample"])


def test_configs_without_family_are_conv_vae():
    assert set(CONV_VAE) == set(CHUNK_FLOPS)
    for name in CONV_VAE:
        assert "family" not in harness.load_json(harness.PB / "configs" / f"{name}.json")
        assert families.of(harness.load_config(name)).__file__ == str(families.HERE / "conv_vae.py")


@pytest.mark.parametrize("name", CONV_VAE)
def test_conv_vae_program_config_as_before(name):
    cfg = harness.load_config(name)
    got, want = families.of(cfg).program_config(cfg), vae_config_before_families(cfg)
    assert type(got) is type(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", CONV_VAE)
def test_conv_vae_weights_are_the_reference_s(name):
    cfg = harness.load_config(name)
    seed = 2**31 + 12345
    got = families.of(cfg).make_params(cfg, seed, torch.device("cpu"))
    want = ref_encoder.make_params(cfg, seed, torch.device("cpu"))
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", CONV_VAE)
def test_conv_vae_least_work_as_before(name):
    cfg = harness.load_config(name)
    assert families.of(cfg).encoder_macs(cfg) == flops.encoder_macs(cfg)
    assert flops.chunk_flops(cfg) == CHUNK_FLOPS[name]
    assert families.of(cfg).latent_dim(cfg) == cfg["latent_dim"]
    assert families.of(cfg).cpu_cut(cfg) == cfg


def bench_dir(tmp_path):
    """A copy of the benchmark's data files under ``tmp_path``."""
    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.PB / d, pb / d)
    return pb


def add_cell(pb, m, cell, like, family):
    """A config of ``family`` (else as ``like``'s), and a cell ``cell`` on it
    with ``like``'s traffic and workload, reporting ``like``'s metrics."""
    entry = next(w for w in m["workloads"] if w["name"] == like)
    cfg = harness.load_json(pb / "configs" / f"{entry['config']}.json")
    cfg["family"] = family
    config = f"{entry['config']}-{cell}"
    (pb / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "workloads" / f"{like}.json", pb / "workloads" / f"{cell}.json")
    m["workloads"].append(dict(entry, name=cell, config=config))
    for e in m["end_to_end"] + m["per_layer"]:
        if like in e.get("workloads", []):
            e["workloads"].append(cell)


@pytest.mark.parametrize("family", ["no-such-family", "../configs/vae-stride", "a.b", "__init__"])
def test_unknown_family_fails_at_load_cell(tmp_path, family):
    pb, m = bench_dir(tmp_path), tiny.manifest()
    add_cell(pb, m, "stride-request-unknown", "stride-request-parity", family)
    with pytest.raises(SystemExit) as e:
        harness.load_cell("stride-request-unknown", m, pb=pb)
    assert repr(family) in str(e.value) and str(families.HERE) in str(e.value)


def write_twin(tmp_path, monkeypatch):
    """A family of its own name that re-exports conv-vae: one new file, in a
    directory searched before the package's."""
    d = tmp_path / "families"
    d.mkdir()
    (d / "conv_vae_twin.py").write_text(
        '"""conv-vae under another name."""\n\nfrom perfbench.families.conv_vae import *  # noqa: F401,F403\n')
    monkeypatch.setattr(families, "SEARCHED", (d, *families.SEARCHED))


def test_train_cell_of_another_family_is_refused(tmp_path, monkeypatch):
    pb, m = bench_dir(tmp_path), tiny.manifest()
    write_twin(tmp_path, monkeypatch)
    add_cell(pb, m, "stride-train-twin", "stride-train-f32", "conv-vae-twin")
    with pytest.raises(SystemExit) as e:
        harness.load_cell("stride-train-twin", m, pb=pb)
    assert "'conv-vae-twin'" in str(e.value) and "train" in str(e.value)


def test_new_family_found_by_name(tmp_path, monkeypatch):
    """The twin's tiny run reads what the ``vae-avgpool`` cell reads, to the last bit."""
    pb, m = bench_dir(tmp_path), tiny.manifest()
    write_twin(tmp_path, monkeypatch)
    add_cell(pb, m, "avgpool-scan-twin", "avgpool-scan-balanced", "conv-vae-twin")
    twin = tiny.cell("avgpool-scan-twin", m, pb)
    assert twin.family.__file__ == families.of(twin.cfg).__file__ == str(tmp_path / "families" / "conv_vae_twin.py")
    got, _ = tiny.run(twin, seed=2**31 + 7, m=m)
    want, _ = tiny.run(tiny.cell("avgpool-scan-balanced"), seed=2**31 + 7)
    assert got["correct"] is True and got["compared"] == want["compared"]
    assert (got["attempted"], got["failed"]) == (want["attempted"], want["failed"])
    traced, _ = tiny.run(twin, seed=2**31 + 8, m=m, trace=True)
    assert traced["correct"] is True and traced["metrics"]["mfu_pct"]["value"] > 0
