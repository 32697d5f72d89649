"""The service layer: the tick loop and the instance."""
