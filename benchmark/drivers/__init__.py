"""The general drivers of the traffic mixes, one per kind."""
