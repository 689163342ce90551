"""When the raw-motion loop may replay its denoiser call as a CUDA graph
(``models/denoise_graph.py``), and what a captured graph is keyed on. The
capture and replay run only on the card (``benchmark/tests/
test_raw_cell.py::test_graphed_loop_is_the_eager_loop``); here the CPU
checks the rules around them, and that the CPU loop never takes a graph."""
import pytest
import torch
from torch.profiler import profile

from benchmark.families import mld_raw as fam
from mld_tpu_torch.models import denoise_graph
from mld_tpu_torch.models.denoiser import RawMotionDenoiser
from mld_tpu_torch.utils import precision, trace
from test_torch_raw_reference import LENGTHS, TEXTS, small_conf

CUDA = torch.device("cuda")


@pytest.fixture
def tracing_off():
    was = trace.enabled()
    trace.enable(False)
    yield
    trace.enable(was)


def test_graph_only_where_nothing_watches_the_launches(tracing_off):
    with torch.no_grad():
        assert denoise_graph.allowed(CUDA)
        assert not denoise_graph.allowed(torch.device("cpu"))
        trace.enable(True)
        assert not denoise_graph.allowed(CUDA)
        trace.enable(False)
        with profile():
            assert not denoise_graph.allowed(CUDA)
        assert denoise_graph.allowed(CUDA)
    assert not denoise_graph.allowed(CUDA)      # gradients on


def test_key_follows_shapes_precision_and_storage():
    den = RawMotionDenoiser(nfeats=7, latent_dim=16, ff_size=32,
                            num_layers=1, num_heads=2, text_encoded_dim=8)
    x, cond = torch.zeros(4, 10, 7), torch.zeros(4, 1, 8)
    mask = torch.ones(4, 10, dtype=torch.bool)
    with precision.matmul_precision("highest"):
        k = denoise_graph.key(den, x, cond, mask)
        assert denoise_graph.key(den, x, cond, mask) == k
        assert denoise_graph.key(den, torch.zeros(4, 12, 7), cond,
                                 torch.ones(4, 12, dtype=torch.bool)) != k
        assert denoise_graph.key(den, x[:2], cond[:2], mask[:2]) != k
        with torch.no_grad():
            den.pose_embd.weight.add_(1.0)      # in place: same graph
        assert denoise_graph.key(den, x, cond, mask) == k
        den.pose_embd.weight = torch.nn.Parameter(
            den.pose_embd.weight.detach().clone())
        assert denoise_graph.key(den, x, cond, mask) != k
        k = denoise_graph.key(den, x, cond, mask)
    with precision.matmul_precision("default"):
        assert denoise_graph.key(den, x, cond, mask) != k


def test_cpu_loop_takes_no_graph(tracing_off):
    mld = fam.build(small_conf(), "cpu")
    mask = torch.arange(16)[None] < torch.tensor(LENGTHS)[:, None]
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        mld.generate_feats(mld.tokenize(TEXTS), mask, generator=g)
    assert mld._graph is None
