"""Native host-library bindings."""
