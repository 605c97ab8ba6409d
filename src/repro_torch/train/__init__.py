"""The port's training side: only the serve step so far."""
