"""Drivers: each builds the port's object for a configuration on the device
and exposes ``initial_state()``, ``step(state, block) -> (outputs, state)``
and ``view(state)``, the state as plain tensors for the reference. A
configuration file names its driver; the reference of the same name judges
it."""
