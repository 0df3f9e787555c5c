"""Observability of the port: the metrics registry (``registry``) and the
request tracer the serving scheduler calls (``trace``). The exporter, the
memory and goodput ledgers and the rest of ``paddle_tpu/monitor`` are ROADMAP
queue 1 item 10."""
