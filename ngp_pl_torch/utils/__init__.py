"""Host-side helpers of the port's entry points."""
