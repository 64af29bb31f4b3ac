"""Host-side model of the API objects the port lowers."""
