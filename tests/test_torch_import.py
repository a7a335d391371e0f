"""The PyTorch port stands alone: importing every module of apsu_tpu_torch
pulls in neither jax nor the JAX package, and no source file imports them."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import apsu_tpu_torch

PKG = Path(apsu_tpu_torch.__file__).parent
ROOT = PKG.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="apsu_tpu_torch.")
    )


def test_import_leaves_jax_and_reference_out():
    mods = _modules()
    assert set(mods) >= {
        "apsu_tpu_torch.engine.evaluator", "apsu_tpu_torch.ops.ntt",
        "apsu_tpu_torch.api.session", "apsu_tpu_torch.api.protocol",
        "apsu_tpu_torch.cli.receiver_cli", "apsu_tpu_torch.cli.sender_cli",
        "apsu_tpu_torch.cli.csv_io", "apsu_tpu_torch.net.wire",
        "apsu_tpu_torch.utils.log", "apsu_tpu_torch.utils.stopwatch",
        "apsu_tpu_torch.ops.roofline", "apsu_tpu_torch.tools.vpu_roofline",
        "apsu_tpu_torch.tools.ntt4p_gl_ab", "apsu_tpu_torch.cli.pd_tool",
        "apsu_tpu_torch.engine.probe", "apsu_tpu_torch.engine.interpolate",
        "apsu_tpu_torch.db.receiver_db", "apsu_tpu_torch.hash.items",
        "apsu_tpu_torch.parallel.mesh", "apsu_tpu_torch.parallel.runtime",
        "apsu_tpu_torch.parallel.multihost", "apsu_tpu_torch.cli.worker_cli",
        *(f"apsu_tpu_torch.mpc.{m}" for m in (
            "baseot", "duplex", "ec", "endgame", "kkrt", "oprf", "osn", "osn_peqt",
            "otext", "peqt", "prg", "silent", "softspoken")),
    }
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'apsu_tpu' or m.startswith('apsu_tpu.')]\n"
        "print(len(bad), bad[:5])\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|apsu_tpu)(\.|\s|$)", re.M)


def test_sources_import_neither_jax_nor_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders, offenders


_LAZY = {
    "run_psu": "apsu_tpu_torch.api.protocol", "run_psu_mpc": "apsu_tpu_torch.api.protocol",
    "PsuResult": "apsu_tpu_torch.api.protocol", "Sender": "apsu_tpu_torch.api.parties",
    "Receiver": "apsu_tpu_torch.api.parties", "ReceiverDB": "apsu_tpu_torch.db.receiver_db",
    "BfvContext": "apsu_tpu_torch.core.bfv",
}


def test_top_level_api_is_lazy_and_the_ports_own():
    """The reference's lazy top-level names (``apsu_tpu/__init__.py``), each
    the port's object; ``import apsu_tpu_torch`` alone loads none of their
    modules, nor jax nor the JAX package, until a name is asked for."""
    import importlib

    for name, module in _LAZY.items():
        assert getattr(apsu_tpu_torch, name) is getattr(importlib.import_module(module), name)
    code = (
        "import sys, apsu_tpu_torch\n"
        f"lazy = {sorted(set(_LAZY.values()))!r}\n"
        "def loaded():\n"
        "    return [m for m in sys.modules if m in lazy or m == 'jax' or m.startswith('jax.')\n"
        "            or m == 'apsu_tpu' or m.startswith('apsu_tpu.')]\n"
        "assert not loaded(), loaded()\n"
        "apsu_tpu_torch.ReceiverDB\n"
        "assert 'apsu_tpu_torch.db.receiver_db' in loaded(), loaded()\n"
        "assert not [m for m in loaded() if 'jax' in m or m.startswith('apsu_tpu.')], loaded()\n"
        "try:\n"
        "    apsu_tpu_torch.no_such_name\n"
        "except AttributeError:\n"
        "    print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr
