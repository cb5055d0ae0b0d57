"""`tests/torch_gloo.py`, the gloo groups of the multi-card tests: a
group that cannot finish fails once, within its limit, with its walls in
the message, and later calls for its size fail at once with that
message; a group that finishes returns every rank's results of its part,
and `Groups` joins the parts."""
import time

import pytest

torch = pytest.importorskip("torch")

from tests.torch_gloo import Groups, Part, run_tasks  # noqa: E402
from tests.torch_gloo import result as rank_result  # noqa: E402

LIMIT = 8.0       # seconds: enough to start the ranks, not to finish a nap


def _tasks(rank, world, d, part):
    import torch.distributed as dist

    def total():
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        return float(t)

    return run_tasks(dict(nap=lambda: time.sleep(d["nap"]), total=total,
                          world=lambda: dist.get_world_size()), part)


def test_group_that_cannot_finish_fails_once(tmp_path_factory):
    groups = Groups(_tasks, lambda world: {"nap": 120.0}, tmp_path_factory,
                    timeout=LIMIT)
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="did not finish within 8 s") as first:
        groups(2)
    assert time.monotonic() - t0 < LIMIT + 15    # killed, not slept out
    msg = str(first.value)
    assert "gloo group of 2: up" in msg and "(wall " in msg, msg
    t1 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match="the groups of 2 failed before") as again:
        groups(2)
    assert time.monotonic() - t1 < 1.0           # no second group
    assert msg in str(again.value)


def test_groups_join_their_parts(tmp_path_factory):
    groups = Groups(_tasks, lambda world: {"nap": 0.0}, tmp_path_factory,
                    parts=(("total",),))
    assert Part(("total",))("total") and not Part(None, ("total",))("total")
    _, outs = groups(2)
    assert [sorted(out) for out in outs] == [["nap", "total", "world"]] * 2
    assert rank_result(outs, "total") == 3.0
    assert rank_result(outs, "world") == 2
