"""chip_smoke.py refuses to report a result without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.parametrize("where", ["checkout", "bare_dir"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """Under JAX_PLATFORMS=cpu the script exits non-zero and never prints
    the result line; in a directory holding only the script it cannot
    import the package and fails the same way."""
    if where == "checkout":
        cwd, script = _REPO, os.path.join(_REPO, "chip_smoke.py")
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
