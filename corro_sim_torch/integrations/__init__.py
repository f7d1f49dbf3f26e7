"""External-system integrations (the reference's consul-client +
`corrosion consul sync` daemon, SURVEY §2.4)."""
