"""With the timed path broken underneath, a run's ``correct`` comes out
false: each fault a cell can have, planted in the port's CPU path at a
tiny size, the rest of the run as the benchmark runs it."""

import pytest

from benchmark import harness
from conftest import CELLS, cpu_run, load_cell, tiny_cell


def failing(cell, out):
    correct, checks = harness.judge(out, cell.limits)
    return not correct


def alter_detections(kind):
    """A postprocess whose answer is altered where it is produced."""
    from yolojax_torch.eval import evaluator

    real = evaluator.postprocess_v2

    def altered(*args, **kw):
        out = real(*args, **kw)
        if kind == "keep":       # one candidate's keep flag flipped
            out["keep"][0, 3] = ~out["keep"][0, 3]
        elif kind == "score":    # one candidate's score doubled
            out["scores"][0, 10] = out["scores"][0, 10] * 2
        elif kind == "class":    # every candidate's class changed
            out["classes"] = (out["classes"] + 7) % 20
        return out

    return real, altered


@pytest.mark.parametrize("name", [n for n, t in CELLS.items()
                                  if t.startswith("detect")])
@pytest.mark.parametrize("kind", ["keep", "score", "class"])
def test_detect_answer_altered(name, kind, monkeypatch):
    from yolojax_torch.eval import evaluator

    _, altered = alter_detections(kind)
    monkeypatch.setattr(evaluator, "postprocess_v2", altered)
    cell = tiny_cell(name)
    _, out = cpu_run(cell)
    assert failing(cell, out)


def wrong_top_k():
    """(cell, skip): the K candidates after the best ``skip`` K. Where the
    cell holds the share outside the reference's K best, the next K;
    every detect cell, the K after the best 2K."""
    for name, traffic in CELLS.items():
        if traffic.startswith("detect"):
            limits = load_cell(name).limits
            for skip in (1, 2):
                if skip == 2 or "topk_out_share" in limits:
                    yield name, skip


@pytest.mark.parametrize("name,skip", list(wrong_top_k()))
def test_detect_wrong_top_k(name, skip, monkeypatch):
    """K candidates in score order, valid boxes with their true scores
    and a sound NMS over them; only the choice is wrong."""
    from yolojax_torch.postprocess import nms

    real = nms._select_candidates

    def next_k(corners, scores, score_thresh, top_k, candidates="auto"):
        boxes, top, classes, valid = real(corners, scores, score_thresh,
                                          (skip + 1) * top_k, candidates)
        rows = slice(skip * top_k, None)
        return (boxes[:, rows], top[:, rows], classes[:, rows],
                valid[:, rows])

    monkeypatch.setattr(nms, "_select_candidates", next_k)
    cell = tiny_cell(name)
    _, out = cpu_run(cell)
    assert failing(cell, out), out.compared


@pytest.mark.parametrize("name", [n for n, t in CELLS.items()
                                  if t.startswith("http")])
def test_reply_altered(name, monkeypatch):
    from yolojax_torch.cli import serve

    real = serve._extract

    def relabelled(*args, **kw):  # each reply's classes changed
        return [(name, (cls + 7) % 20, score, box)
                for name, cls, score, box in real(*args, **kw)]

    monkeypatch.setattr(serve, "_extract", relabelled)
    cell = tiny_cell(name)
    _, out = cpu_run(cell)
    assert failing(cell, out)


@pytest.mark.parametrize("name", [n for n, t in CELLS.items()
                                  if t.startswith("http")])
@pytest.mark.parametrize("keep", ["none", "half"])
def test_reply_cut(name, keep, monkeypatch):
    """Replies that carry none, or the best half, of their detections:
    each detection left is sound."""
    from yolojax_torch.cli import serve

    real = serve._extract

    def cut(*args, **kw):
        dets = real(*args, **kw)
        return [] if keep == "none" else dets[:len(dets) // 2]

    monkeypatch.setattr(serve, "_extract", cut)
    cell = tiny_cell(name)
    _, out = cpu_run(cell)
    assert failing(cell, out), out.compared


@pytest.mark.parametrize("name", [n for n, t in CELLS.items()
                                  if t.startswith("train")])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_train_step_broken(name, fault):
    cell = tiny_cell(name, **{"train.compute_dtype": "float32"})
    _, out = cpu_run(cell, fault=fault)
    assert failing(cell, out)
