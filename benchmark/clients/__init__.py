"""Clients of the traffic mixes, one module each, found by the ``client``
a traffic file names: each defines ``Client``
(:class:`benchmark.harness.client.Client`)."""
