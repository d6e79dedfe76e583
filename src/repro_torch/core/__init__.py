"""Host-side protection and the multiplexer: numpy code copied, not
imported, from `repro.core`."""
