"""Configuration kinds (``portbench/kinds/<kind>.py``): a kind with numbers
of its own added to a copy of the benchmark by new files alone; the
``unet`` kind reading what the harness read before kinds were modules; a
traffic mix refused without ``trace_seconds``."""

import contextlib
import copy
import json

import pytest
import torch

from portbench import spec
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_harness import BENCH, _checkout, _kind, _run, _tiny

# a kind that serves the U-Net and judges it by its own number: the share
# of served labels that are not the plain reference's best class
AGREEMENT_KIND = '''
"""The U-Net judged by ``label_disagreement``."""

import torch

from portbench import check, reference
from portbench.kinds import unet

SERVER_KIND = unet.SERVER_KIND
make_flat, flops_per_voxel = unet.make_flat, unet.flops_per_voxel
small_traffic, altered_answers = unet.small_traffic, unet.altered_answers


class _Disagreement:
    def __init__(self, ref):
        self.ref, self.differ, self.compared = ref, 0, 0

    def label(self, i, lab):
        best = self.ref.scores(i).argmax(0)
        self.differ += int((best != torch.as_tensor(lab).to(torch.int64)).sum())
        self.compared += best.numel()

    def add(self, output, item_indices):
        for i, lab in zip(item_indices, check.read_labels(output)):
            self.label(i, lab.astype("int64"))

    def readings(self):
        return {"label_disagreement": self.differ / max(self.compared, 1)}


def judge(cfg, traffic, items, flat, device):
    return _Disagreement(unet.class_judge(cfg, traffic, items, flat, device))


def control_readings(cfg, traffic, items, flat, device):
    ref = unet.class_judge(cfg, traffic, items, flat, device)
    d = _Disagreement(ref)
    for i, item in enumerate(items):
        low = reference.class_scores(ref.wts, item, ref.patch, ref.overlap, device, fp8=True)
        d.label(i, low.argmax(0))
    return d.readings()
'''

# the tiny cell's ``check`` at the commit before kinds were modules (seed
# 2**31 + 11, a 3 s window, one intra-op thread)
PINNED = {"missing": 0, "max_gap": 0.008609414100646973, "mismatch_share": 0.00018310546875}


@pytest.fixture(scope="module")
def agreement(tmp_path_factory):
    """A copy with the ``agreement`` kind added by new files and entries:
    the kind, a configuration of it at the trained net's widths, a traffic
    mix, and the limits of its cells ``agree.tiny`` (its own number) and
    ``agree.absent`` (a number the kind does not give). The limit lies
    between the program's 1.2e-4 and the float8 control's 1.3e-3 to 5.6e-3
    (seeds 5, 6, 7, 2**31 + 3) on the CPU at this size."""
    root = _checkout(tmp_path_factory.mktemp("agreement"))
    bench = copy.deepcopy(BENCH)
    (root / "portbench/kinds/agreement.py").write_text(AGREEMENT_KIND)
    cfg = json.loads((root / BENCH["configs"][0]["file"]).read_text())
    cfg.update(name="unet2d_agreement", kind="agreement",
               model={**cfg["weights"]["embed"]["model"], "norm": "none"})
    (root / "portbench/configs/unet2d_agreement.json").write_text(json.dumps(cfg))
    bench["configs"].append({**BENCH["configs"][0], "name": "unet2d_agreement",
                             "file": "portbench/configs/unet2d_agreement.json"})
    (root / "portbench/traffic/agree_tiny.json").write_text(json.dumps(_tiny("seg2d.timelapse")))
    (root / "portbench/limits/agree.tiny.json").write_text(
        json.dumps({"missing": 0, "label_disagreement": 0.0006}))
    (root / "portbench/limits/agree.absent.json").write_text(
        json.dumps({"missing": 0, "label_disagreement": 0.0006, "max_gap": 0.3}))
    for name in ("agree.tiny", "agree.absent"):
        bench["workloads"].append({"name": name, "config": "unet2d_agreement",
                                   "traffic": "agree_tiny", "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "answer_altered"])
def test_a_new_kind_is_judged_by_its_own_numbers(agreement, broken, tmp_path):
    kind = _kind("agree.tiny", agreement)
    with kind.altered_answers() if broken else contextlib.nullcontext():
        result = _run(agreement, "agree.tiny", 2**31 + 17, 3.0, tmp_path)
    assert list(result["check"]) == ["missing", "label_disagreement"]
    assert result["correct"] is (not broken), result["check"]


def test_a_limit_the_judge_does_not_give_ends_the_run_without_a_result(agreement, tmp_path):
    assert _run(agreement, "agree.absent", 2**31 + 17, 3.0, tmp_path, rc=4) is None
    assert "max_gap" in (tmp_path / "err.txt").read_text()


def test_the_new_kinds_control_fails_its_limit(agreement):
    from portbench.tools.control import control_readings

    readings = control_readings(agreement, "agree.tiny", 5, "cpu", _tiny("agree.tiny", agreement))
    assert readings["label_disagreement"] > 0.0006, readings


def test_the_unet_kind_reads_what_the_harness_read_before(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = _run(ROOT, "seg2d.timelapse", 2**31 + 11, 3.0, tmp_path)
    finally:
        torch.set_num_threads(threads)
    assert {k: v["value"] for k, v in result["check"].items()} == PINNED
    assert list(result["check"]) == ["missing", "max_gap", "mismatch_share"]


def test_the_unet_kind_counts_the_published_unets_flops():
    cfg = spec.config_of(BENCH, ROOT, "unet2d_ronneberger")
    assert _kind("seg2d.timelapse").flops_per_voxel(cfg) == 1_467_904


def test_a_traffic_mix_without_trace_seconds_is_refused_at_load(tmp_path):
    root = _checkout(tmp_path)
    path = root / "portbench/traffic/timelapse64.json"
    mix = json.loads(path.read_text())
    for cap in (None, 0, "20"):
        if cap is None:
            mix.pop("trace_seconds")
        else:
            mix["trace_seconds"] = cap
        path.write_text(json.dumps(mix))
        with pytest.raises(ValueError, match="trace_seconds"):
            spec.traffic_of(str(root), "timelapse64")
