"""Capability gates and self-launch helpers (counterpart of
``accelerate_tpu/test_utils/testing.py``).

``execute_subprocess`` runs a command and raises with its whole output on
failure; ``launch_script`` runs a script through the port's launcher
(``DEFAULT_LAUNCH_COMMAND``) with the repository on ``PYTHONPATH``;
``require_multiprocess`` skips a test outside a multi-process launch.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional, Sequence

__all__ = [
    "DEFAULT_LAUNCH_COMMAND",
    "execute_subprocess",
    "launch_env",
    "launch_script",
    "require_multiprocess",
]

DEFAULT_LAUNCH_COMMAND = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def require_multiprocess(test_case):
    """Runs only inside a launch of more than one process."""
    import pytest

    return pytest.mark.skipif(int(os.environ.get("WORLD_SIZE", "1")) <= 1,
                              reason="test requires a multi-process launch")(test_case)


def launch_env(**extra) -> dict:
    """This environment with the repository first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def execute_subprocess(cmd: Sequence[str], env: Optional[dict] = None,
                       timeout: float = 900) -> subprocess.CompletedProcess:
    """Run ``cmd``; raise with its whole stdout and stderr when it fails."""
    result = subprocess.run(list(cmd), env=env or os.environ.copy(), capture_output=True,
                            text=True, timeout=timeout)
    if result.returncode != 0:
        raise RuntimeError(f"command {list(cmd)} failed rc={result.returncode}\n"
                           f"--- stdout ---\n{result.stdout}\n--- stderr ---\n{result.stderr}")
    return result


def launch_script(script: str, script_args: Sequence[str] = (), launch_args: Sequence[str] = (),
                  env: Optional[dict] = None, timeout: float = 900) -> subprocess.CompletedProcess:
    """Run ``script`` through the port's launcher."""
    cmd = [*DEFAULT_LAUNCH_COMMAND, *launch_args, script, *script_args]
    return execute_subprocess(cmd, env=env or launch_env(), timeout=timeout)
