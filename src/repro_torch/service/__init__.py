"""The study service: a long-lived multi-tenant ``LanePool`` daemon.

Mirrors ``src/repro/service/``: ``server`` is the daemon
(``StudyService`` core + ``StudyServer`` socket front end), ``client`` the
tenant-side API, ``protocol`` the JSON-lines wire format.
``python -m repro_torch.service`` runs the daemon (``__main__.py``).
"""
from repro_torch.service.client import (PlanRejectedByServer,  # noqa: F401
                                        ServedStudy, StudyClient)
from repro_torch.service.server import (StudyServer,  # noqa: F401
                                        StudyService)
