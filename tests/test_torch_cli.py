"""The port's operator CLI (``dcos_commons_tpu_torch/cli``) against the
JAX package's, on the CPU, over real loopback sockets.

tests/test_cli.py's scenarios run four times: the JAX CLI against the
JAX server (as they are), the port's CLI against the port's server,
and across: the port's CLI against the JAX server and the JAX CLI
against the port's.  Every CLI call's exit code, standard output and
standard error is recorded (its ``--url`` left out), and the four
records must be the same: JSON output equal once test_torch_scheduler's
``designed`` maps out a port server's card env, text equal as it is.
Each scenario's own assertions must hold in all four.  Errors surface
as the same exit codes (an HTTP error, an unreachable scheduler, a bad
argument), and ``python -m dcos_commons_tpu_torch cli`` runs as a
subprocess with a token file as ``python -m dcos_commons_tpu cli``
does.

Ids, clocks and span ids are pinned as test_torch_http pins them."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import types

import pytest

from dcos_commons_tpu.cli import commands as j_commands
from dcos_commons_tpu_torch.cli import commands as t_commands
from test_torch_http import Twin, freeze, restart_ids
from test_torch_http import JAX as J_HTTP, PORT as T_HTTP
from test_torch_scheduler import designed, pin_ids, pinned  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# (CLI package, server package): the scenarios' four runs
COMBOS = (("jax", "jax"), ("port", "port"), ("port", "jax"), ("jax", "port"))


def scenario_module(cli, server):
    """tests/test_cli.py with its CLI imports pointed at ``cli``'s
    package and every other import at ``server``'s."""
    with open(os.path.join(HERE, "test_cli.py")) as f:
        source = f.read()
    # the subprocess case runs from this checkout, wherever it lies
    source = re.sub(r'cwd="[^"]*"', f"cwd={REPO!r}",
                    source.replace("dcos_commons_tpu.cli", "@CLI@"))
    if server == "port":
        source = source.replace("dcos_commons_tpu.",
                                "dcos_commons_tpu_torch.")
    source = source.replace("@CLI@", "dcos_commons_tpu_torch.cli"
                            if cli == "port" else "dcos_commons_tpu.cli")
    module = types.ModuleType(f"cli_{cli}_{server}")
    module.__file__ = os.path.join(HERE, "test_cli.py")
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


MODULES = {combo: scenario_module(*combo) for combo in COMBOS}
CASES = sorted(n for n in vars(MODULES[COMBOS[0]]) if n.startswith("test_"))


class Capture:
    """What a scenario's ``capsys`` reads: the CLI's output since the
    last read."""

    def __init__(self):
        self.out = self.err = ""

    def readouterr(self):
        out = types.SimpleNamespace(out=self.out, err=self.err)
        self.out = self.err = ""
        return out


def recording(monkeypatch, module, log, capture, port_server):
    """``module.main`` that records (argv but the URL, rc, stdout,
    stderr) of each call and hands the output on to ``capture``."""
    original = module.main

    def main(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = original(argv)
        capture.out += out.getvalue()
        capture.err += err.getvalue()
        try:
            shown = designed(json.loads(out.getvalue()), port_server)
        except json.JSONDecodeError:
            shown = out.getvalue()
        log.append((argv[2:], rc, shown, err.getvalue()))
        return rc

    monkeypatch.setattr(module, "main", main)


def deployed(module):
    """tests/test_cli.py's ``deployed`` fixture, on ``module``'s
    package."""
    runner = module.ServiceTestRunner(module.YAML)
    runner.run([
        module.AdvanceCycles(1),
        module.SendTaskRunning("app-0-main"),
        module.ExpectDeploymentComplete(),
    ])
    return runner, module.ApiServer(runner.world.scheduler).start()


def test_every_scenario_is_run():
    assert len(CASES) == 9


@pytest.mark.parametrize("name", CASES)
def test_cli_scenario_prints_as_the_jax_cli(name, pinned, monkeypatch):
    freeze(monkeypatch, pinned)
    logs = {}
    for combo in COMBOS:
        pin_ids(monkeypatch)
        restart_ids(monkeypatch)
        module = MODULES[combo]
        log, capture = [], Capture()
        recording(monkeypatch, module, log, capture, combo[1] == "port")
        runner, server = deployed(module)
        try:
            case = getattr(module, name)
            params = case.__code__.co_varnames[:case.__code__.co_argcount]
            case(**{"deployed": (runner, server), "capsys": capture}
                 if "capsys" in params else {"deployed": (runner, server)})
        finally:
            server.stop()
        logs[combo] = log
    for combo in COMBOS[1:]:
        assert logs[combo] == logs[COMBOS[0]], combo


# -- errors and the process boundary ------------------------------------

CLIS = {"jax": j_commands, "port": t_commands}


def run_main(commands, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = commands.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["plan", "show", "nope"],
    ["pod", "restart", "nope-0"],
    ["plan"],
    ["plan", "bogus-verb"],
    ["--bogus"],
    [],
])
def test_errors_surface_as_the_same_exit_code(argv, pinned, monkeypatch):
    freeze(monkeypatch, pinned)
    out = []
    for pkg in (J_HTTP, T_HTTP):
        restart_ids(monkeypatch)
        twin = Twin(pkg)
        try:
            results = [run_main(CLIS[cli], ["--url", twin.server.url, *argv])
                       for cli in ("jax", "port")]
        finally:
            twin.stop()
        assert results[1] == results[0]
        out.append(results[0])
    assert out[1] == out[0]
    assert out[0][0] in (1, 2)


def test_unreachable_scheduler_is_the_same_error():
    url = "http://127.0.0.1:9"
    results = [run_main(CLIS[cli], ["--url", url, "plan", "list"])
               for cli in ("jax", "port")]
    assert results[1] == results[0]
    assert results[0][0] == 1 and "cannot reach scheduler" in results[0][2]


def test_cli_as_a_subprocess_with_a_token(pinned, monkeypatch, tmp_path):
    """``python -m dcos_commons_tpu_torch cli`` against the port's server
    with a bearer token, and ``python -m dcos_commons_tpu cli`` against
    the JAX one: the same output; without the token, the same 401."""
    freeze(monkeypatch, pinned)
    token = tmp_path / "token"
    token.write_text("s3cret-token\n")
    outs = []
    for pkg, module in ((J_HTTP, "dcos_commons_tpu"),
                        (T_HTTP, "dcos_commons_tpu_torch")):
        restart_ids(monkeypatch)
        twin = Twin(pkg, "s3cret-token")
        try:
            runs = []
            for extra in (["--auth-token-file", str(token)], []):
                proc = subprocess.run(
                    [sys.executable, "-m", module, "cli", "--url",
                     twin.server.url, *extra, "plan", "list"],
                    cwd=REPO, capture_output=True, text=True, timeout=60)
                runs.append((proc.returncode, proc.stdout,
                             proc.stderr.replace(twin.server.url, "<url>")))
        finally:
            twin.stop()
        outs.append(runs)
    assert outs[1] == outs[0]
    (rc, stdout, _), (rc_no_token, _, stderr) = outs[0]
    assert rc == 0 and json.loads(stdout) == ["autoscale", "backup",
                                              "deploy", "recovery"]
    assert rc_no_token == 1 and "HTTP 401" in stderr
