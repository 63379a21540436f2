"""The port's benchmark harness: cells found by name (`cells`), traffic
(`traffic`), the host's record (`host`), one run (`bench`), the check
against the plain reference (`check`) and the traced run's instruments
(`trace`, `roofline`)."""
