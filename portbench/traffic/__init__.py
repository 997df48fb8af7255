"""Traffic kinds (``<kind>.py``) and traffic mixes (``<mix>.json``)."""
