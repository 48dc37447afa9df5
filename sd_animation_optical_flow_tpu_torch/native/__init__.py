"""Native host-side helpers of the port (the frame pipe)."""
