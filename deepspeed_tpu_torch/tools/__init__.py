"""Command-line tools of the port: a serving replica as a process
(``fleet_replica``), the fleet controller (``fleetctl``) and the
workload-trace tools (``replay_trace``, ``analyze_trace``,
``plan_capacity``, ``gen_sample_trace``)."""
