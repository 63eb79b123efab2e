"""The cell thumbs-batch (configuration cavif-mixed-thumbs): its readers of
the alpha stream's spans and of the colour frames' share of the card, on
synthetic windows and on the parent's table, its discovery with its RGBA
pool and alpha limit, and a traced run on the CPU at an eighth of its
image sizes."""

import pytest
import run as R
from harness import spec
from traffic import generate

from helpers import args
from test_bench_tracing import PARENT, read, win

NEW = ("thumbs.alpha_prep_s", "thumbs.alpha_stream_s", "thumbs.card_share")
# a list of 32 as the cell sends it: 4 RGBA images, each with an alpha
# stream, every frame's pass 1 on the card
LIST = {"alpha.prep": 0.8, "n_alpha.prep": 4, "alpha.stream": 6.0,
        "n_alpha.stream": 4, "n_device_pass1": 36, "device_pass1.mono": 4}


def test_alpha_seconds_per_call():
    w = win(LIST, answered=32)
    assert read("thumbs.alpha_prep_s", w) == pytest.approx(0.2)
    assert read("thumbs.alpha_stream_s", w) == pytest.approx(1.5)


def test_the_card_share_counts_colour_frames_once():
    assert read("thumbs.card_share", win(LIST, answered=32)) == 100.0
    # 2 images on the host cascade: 30 colour frames of 32 images
    w = win({**LIST, "n_device_pass1": 34}, answered=32)
    assert read("thumbs.card_share", w) == pytest.approx(93.75)
    # where pool.card_share counts the alpha frames as images
    assert read("pool.card_share", win(LIST, answered=32)) == 112.5


@pytest.mark.parametrize("name", NEW)
def test_no_reading_without_the_spans_or_the_counter(name):
    assert read(name, win(PARENT)) is None
    assert read(name, win({})) is None


def test_the_cell_is_found_with_its_rgba_pool_and_alpha_limit():
    cell = spec.cell("thumbs-batch")
    assert cell.config["name"] == "cavif-mixed-thumbs"
    assert cell.config["encoder"]["alpha_quality"] == 90
    assert cell.spec["entry"] == "encode_batch"
    assert cell.spec["list_length"] == 32
    # one list's images, walked again by every list of the window
    assert cell.spec["pool"] == 32
    assert 0 < cell.spec["limits"]["alpha_rmse_worst"] < 12
    assert {m["name"] for m in cell.end_to_end} == {
        "encode_mps", "avif_bpp", "rmse_levels", "setup_s"}
    per = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= per
    # the chain's wait and its issuing threads run as in the 1 MP batch
    assert {"stage.filters_wait_s_per_mp",
            "stage.filters_issue_cpu_share"} <= per
    assert not per & {"pool.card_share", "kernel.k1k2_roofline"}
    pool = generate(cell.config["image"], 2_147_483_999, 8, "cpu")
    # the warm-up's first 8 hold the four sizes and the first RGBA image
    assert {im.shape[:2] for im in pool} == {
        (384, 512), (512, 512), (256, 384), (512, 768)}
    assert [i for i, im in enumerate(pool) if im.shape[2] == 4] == [3]
    assert pool[3].shape == (512, 768, 4)


def thumbs_cpu():
    """thumbs-batch at an eighth of its sizes, lists of 8."""
    cell = spec.cell("thumbs-batch")
    cell.config["image"]["shapes"] = [[48, 64], [64, 64], [32, 48],
                                      [64, 96]]
    cell.spec.update(pool=8, list_length=8, warmup=[1, 8],
                     profile={"start_s": 0.2, "seconds": 1.0})
    return cell


def test_a_traced_run_reports_the_alpha_stream(monkeypatch):
    """On threads, as encode_batch runs on the card (the CPU default forks
    workers, whose spans stay in them)."""
    from cavif_tpu_torch.parallel import batch

    monkeypatch.setattr(batch, "_fork_ok", lambda: False)
    cell = thumbs_cpu()
    res, check = R.run(args(cell.name, seconds=2.0, trace=1), cell,
                       device="cpu")
    assert res["correct"], (res, check)
    got = res["metrics"]
    for m in NEW:
        assert got[m]["value"] > 0, (m, got)
    assert got["thumbs.card_share"]["value"] == 100.0
    assert check["alpha_rmse_worst"]["value"] > 0
