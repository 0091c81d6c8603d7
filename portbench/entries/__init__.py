"""General drivers of the traffic mixes; a mix's JSON names its entry."""
