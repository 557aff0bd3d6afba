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
simulated fleet maps to a sandbox directory).

Port of ``dcos_commons_tpu/agent/__init__.py`` but the agent daemon
and the remote client (``AgentDaemon``, ``RemoteAgentClient``,
``RemoteFleet``), which the port does not have yet.
"""

from dcos_commons_tpu_torch.agent.base import Agent
from dcos_commons_tpu_torch.agent.local import LocalProcessAgent

__all__ = [
    "Agent",
    "LocalProcessAgent",
]
