"""The captioner's serving stack and the browser demo (counterpart of
`faithdiff_tpu/serving/`): `controller` (worker registry, heartbeats,
dispatch, failover), `worker` (a CaptionAgent behind the controller),
`external_worker` (a worker proxying an external inference server),
`chat` (a terminal chat over one image) and `web_demo` (caption and
restore in a browser page)."""
