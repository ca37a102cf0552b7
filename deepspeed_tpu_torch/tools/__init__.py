"""Command-line tools of the port: a serving replica as a process
(``fleet_replica``) and the fleet controller (``fleetctl``)."""
