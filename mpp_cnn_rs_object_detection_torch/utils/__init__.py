"""File helpers, the metrics log, path/config resolution and the PNG
codec."""
