"""`utils/progress.py` against the JAX package's: the progress bar writes
the same frames (elapsed seconds masked), the stage timer sums into a
sink or writes to a stream, and `torch_trace` (JAX's `jax_trace`) leaves
a trace of the block in its directory."""
import io
import json
import re

import pytest
import torch

from ccgp_tpu.utils import progress as jprog
from ccgp_tpu_torch.utils import progress as tprog


def frames(mod, items, **kw):
    out = io.StringIO()
    got = list(mod.progress(items, stream=out, **kw))
    return got, re.sub(r" *\d+\.\ds", " Ts", out.getvalue())


@pytest.mark.parametrize("kw", [dict(), dict(width=10, label="fit "),
                                dict(total=3)])
def test_progress_writes_jax_frames(kw):
    got, text = frames(tprog, iter([4, 5, 6]) if "total" in kw else [4, 5, 6],
                       **kw)
    ref, jtext = frames(jprog, iter([4, 5, 6]) if "total" in kw else [4, 5, 6],
                        **kw)
    assert got == ref == [4, 5, 6]
    assert text == jtext and text.endswith("3/3 Ts\n")


def test_stage_timer_sink_and_stream():
    sink = {}
    for _ in range(2):
        with tprog.stage_timer("fit", sink):
            pass
    assert set(sink) == {"fit"} and 0.0 <= sink["fit"] < 1.0
    out = io.StringIO()
    with tprog.stage_timer("predict", stream=out):
        pass
    assert re.fullmatch(r"\[predict\] \d+\.\d ms\n", out.getvalue())


def test_torch_trace_writes_a_trace(tmp_path):
    with tprog.torch_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
