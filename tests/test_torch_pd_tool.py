"""The port's power-schedule tool prints exactly what the reference's does,
byte for byte, for the two calls of its usage line."""

import contextlib
import io

import pytest

from apsu_tpu.cli import pd_tool as ref_pd_tool
from apsu_tpu_torch.cli import pd_tool


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--params", "parameters/16M-4096.json", "--dot"],
    ["--powers", "1,3,11,18,45,225", "--bound", "1304", "--ps", "44"],
    ["--params", "parameters/1M-2048-cmp.json", "--dot"],
])
def test_pd_tool_stdout_matches_reference(argv):
    got = _stdout(pd_tool.main, argv)
    assert got == _stdout(ref_pd_tool.main, argv)
    assert got.startswith("sources: ")
