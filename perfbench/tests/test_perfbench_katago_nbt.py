"""The nested-bottleneck configuration through the architecture seam: a
small cell naming ``katago_nbt`` runs on the CPU through the program's
plain kernels and reads correct; the same cell with a planted fault in a
kernel's arithmetic reads not correct. The kernels' spans are the
architecture's, and the cell's FLOPs are its file's."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from conftest import ROOT, tiny
from perfbench import generator, harness

CELL = "renju19_b18c384nbt.selfplay400"
SMALL_NET = {"arch": "katago_nbt", "blocks": 3, "channels": 32,
             "mid_channels": 16, "gpool_channels": 8, "gpool_blocks": [3],
             "head_channels": 8, "value_hidden": 16,
             "compute_dtype": "bfloat16", "use_pallas": True}


def small_cell():
    cfg_doc, mix = tiny("selfplay", rules="renju")
    cfg_doc["arch"] = "katago_nbt"
    cfg_doc["net"] = dict(SMALL_NET)
    mix["timed"] = list(mix["timed"]) + ["nbt_pair", "nbt_gpool",
                                         "nbt_conv1x1"]
    return cfg_doc, mix


# the small cell's policy limit: at 3 blocks of 32 on 9×9 a sound run
# reads 0.008–0.013 and the planted faults 0.047 (padding activated),
# 0.080 (pooling dropped), 0.82 (prologue skipped) (CPU, seed 2^31 + 41),
# while the cell's own limit is set at its size, where bf16 reads more
TINY_LIMITS = {"policy_tv": 0.03}


def limits():
    return dict(generator.load_json(os.path.join(
        ROOT, "perfbench", "limits", f"{CELL}.json")), **TINY_LIMITS)


def run_small(seed=2 ** 31 + 41, trace=False):
    cfg_doc, mix = small_cell()
    return harness.run(cfg_doc, mix, limits(), workload="tiny", seed=seed,
                       seconds=2.0, trace=trace, device="cpu", root=ROOT,
                       t_start=time.perf_counter(), metrics=["setup_s"])


def test_the_configuration_is_the_published_net():
    """The cell's configuration: b18c384nbt's widths and depth, uncut, and
    the FLOPs it states are its architecture's count."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _, cfg_doc, mix, lim, e2e, layer = harness.cell(bench, CELL, ROOT)
    net = cfg_doc["net"]
    assert (net["blocks"], net["channels"], net["mid_channels"],
            net["gpool_channels"], net["gpool_blocks"]) == (
        18, 384, 192, 64, [3, 6, 9, 12, 15])
    arch = generator.Arch(cfg_doc)
    assert arch.name == "katago_nbt"
    assert arch.flops_per_position() == cfg_doc["net_flops_per_position"]
    assert abs(arch.flops_per_position() / 18.82e9 - 1) < 1e-3
    calls = {s: sum(k for *_, k in arch.kernel_work(s, 4096))
             for s, _ in arch.kernels()}
    assert calls == {"nbt_pair": 31, "nbt_gpool": 5, "nbt_conv1x1": 36}
    assert "nbt_pair_roofline.selfplay" in layer
    assert "resblock_roofline.selfplay" not in layer
    assert "selfplay_env_steps_per_s" in e2e


def test_the_new_configuration_comes_through_the_seam():
    """Weights from the architecture's draw, the reference's evaluations,
    the stagger and the kernels' spans (timers on each entry point) come
    through ``archs/katago_nbt.py``; the run reads correct."""
    res = run_small(trace=True)
    assert res["correct"] is True, res["checks"]
    rec = res["run"]
    assert set(rec.work["bounds_s"]) == {"nbt_pair", "nbt_gpool",
                                         "nbt_conv1x1"}
    for span in ("nbt_pair", "nbt_gpool", "nbt_conv1x1"):
        assert rec.timers[span] > 0, span
    assert res["readings"]["evaluations"] > 0


def pooling_dropped(monkeypatch):
    """The pooling pair adds no pooled bias: A_2(r) in place of A_2(r +
    Dense(Pool_g(g)))."""
    from alphafive_tpu_torch.ops import katago_nbt as nbt
    monkeypatch.setattr(nbt, "gpool_shift_reference",
                        lambda g, wl, s2, t2: t2.expand(g.shape[0], -1))


def prologue_skipped(monkeypatch):
    """The convs read their input as it is, not A(input)."""
    from alphafive_tpu_torch.ops import katago_nbt as nbt
    monkeypatch.setattr(nbt, "_prologue", lambda x, scale, shift: x)


def padding_activated(monkeypatch):
    """The 3×3 pair pads h with zeros before A_1, so that the border reads
    A_1(0) = ReLU(β₁) where it should read 0."""
    from alphafive_tpu_torch.ops import katago_nbt as nbt

    def pair(h, s1, t1, w1, s2, t2, w2):
        hp = torch.nn.functional.pad(h.float(), (0, 0, 1, 1, 1, 1))
        u = torch.relu(hp * s1 + t1).to(h.dtype).float().permute(0, 3, 1, 2)
        k = w1.float().reshape(w1.shape[0], 3, 3, -1).permute(0, 3, 1, 2)
        z = torch.nn.functional.conv2d(u, k).permute(0, 2, 3, 1)
        y = torch.relu(z * s2 + t2).to(h.dtype)
        return (nbt._conv(y, w2) + h.float()).to(h.dtype)
    monkeypatch.setattr(nbt, "preact_pair_reference", pair)


@pytest.mark.parametrize("fault", [pooling_dropped, prologue_skipped,
                                   padding_activated])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_small()
    assert res["correct"] is False, res["checks"]
    assert (res["checks"]["policy_tv"]["value"]
            > res["checks"]["policy_tv"]["limit"]
            or res["checks"]["value_gap"]["value"]
            > res["checks"]["value_gap"]["limit"]), res["checks"]
