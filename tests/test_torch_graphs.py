"""`utils.graphs.BlockGraph.load_operands`, on the CPU: a load copies in
only the tensors that are not the ones loaded last."""
import pytest

torch = pytest.importorskip("torch")

from abip_tpu_torch.utils.graphs import BlockGraph  # noqa: E402


def test_load_skips_an_unchanged_operand_and_recopies_a_replaced_one():
    a, b = torch.arange(4.0), torch.ones(3)
    block = BlockGraph(torch.zeros(1, dtype=torch.int64), [("a", a), ("b", b)])
    block.load_operands([("a", a), ("b", b)])
    assert torch.equal(block.static["a"], a)
    assert torch.equal(block.static["b"], b)
    for buf in block.static.values():
        buf.fill_(-1.0)             # a mark that only a copy overwrites
    b2 = torch.full((3,), 7.0)
    block.load_operands([("a", a), ("b", b2)])
    assert torch.equal(block.static["a"], torch.full((4,), -1.0))
    assert torch.equal(block.static["b"], b2)
    assert block.static["b"] is not b2
