"""HTTP API (L6): the operator surface of the scheduler.

Reference: sdk/scheduler/.../http/ — Jersey resources over the plan
managers and state store, consumed by the CLI and operators.  The
rebuild serves the same /v1 verb set from the Python stdlib HTTP
server (no Jetty): plans CRUD + interrupt/continue/forceComplete/
restart (queries/PlansQueries.java:47-231), pod list/status/info/
pause/resume/restart/replace (queries/PodQueries.java:69-263), config
list/target, state properties, endpoints discovery, artifact config
templates (endpoints/ArtifactResource.java:17,50), health
(HealthResource), debug trackers (DebugEndpoint), and metrics
scrape (Metrics.java:85-97).

Port of ``dcos_commons_tpu/http/__init__.py``, line for line but the imports.
"""

from dcos_commons_tpu_torch.http.api import SchedulerApi
from dcos_commons_tpu_torch.http.server import ApiServer

__all__ = ["SchedulerApi", "ApiServer"]
