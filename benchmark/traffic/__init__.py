"""Traffic: the clip pool every mix draws from (``clips``) and one driver
per kind of mix, found by the ``driver`` named in the cell's file under
``benchmark/workloads/``: ``closed_loop`` (clients that each send a request
and wait for its answer)."""
