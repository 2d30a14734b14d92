"""Host-side performance helpers of the port (the root-ascent memo)."""
