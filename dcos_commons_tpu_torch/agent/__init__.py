"""Per-host agents: launch, kill, observe tasks.

The reference splits this between Mesos agents (launching containers)
and the sdk/bootstrap Go binary running inside each sandbox (DNS wait,
config render, CA install — sdk/bootstrap/main.go:65-98).  The port
owns both halves: an Agent launches worker processes on a host and
provisions the sandbox (env, config templates, the card env
``CUDA_VISIBLE_DEVICES`` the evaluator assigned), and reports
TaskStatus transitions back to the scheduler.

LocalProcessAgent runs tasks as real subprocesses on this machine,
each under the native ``task_exec`` supervisor (every host in the
simulated fleet maps to a sandbox directory).  A deployment runs one
``AgentDaemon`` per GPU host speaking the same interface over HTTP, and
the scheduler reaches them through a ``RemoteFleet``.

Port of ``dcos_commons_tpu/agent/__init__.py``, line for line but the
imports.
"""

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.agent.local import LocalProcessAgent


def __getattr__(name):
    # daemon/remote pull in http machinery; import lazily so the core
    # package stays light for workload-only users
    if name in ("AgentDaemon",):
        from dcos_commons_tpu_torch.agent.daemon import AgentDaemon

        return AgentDaemon
    if name in ("RemoteAgentClient", "RemoteFleet"):
        from dcos_commons_tpu_torch.agent import remote

        return getattr(remote, name)
    raise AttributeError(name)


__all__ = [
    "Agent",
    "AgentDaemon",
    "LocalProcessAgent",
    "RemoteAgentClient",
    "RemoteFleet",
]
