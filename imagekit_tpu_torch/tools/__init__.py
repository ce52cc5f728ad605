"""Tools of the port: measurement scripts run on a card, the source
writers (``sources``), the chaos soak of a live server (``soak``) and the
mutation fuzz of the native decoders (``fuzz_codecs``)."""
